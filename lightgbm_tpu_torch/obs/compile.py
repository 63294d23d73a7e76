"""Compile attribution: what the port compiles, for which signature, at
what cost.

The port's copy of the JAX package's ``obs/compile.py``.  The JAX package
counts XLA compiles of its jitted entries; the port compiles nothing per
call, and its counterpart of a compile is set-up work done once per
input signature:

* a CUDA graph capture: the fused iteration's tree, tail and score
  graphs (``ops/fused_iter.py``, again when the score tensor's scale
  changes) and the serving tier's bucket programs
  (``serve/executable.py``), each announced through the observer's
  ``capture`` hook;
* the kernels' first build and load in the process (``_build.py``),
  attributed to the entry whose call triggered it (``entry_args``
  before the call, ``entry_end`` after).

``CompileTracker`` hangs off the RunObserver (``obs_compile=true``, or
``obs_utilization_every``).  Each compile lands as a schema-3
``compile_attr`` event with the signature of the tensors involved --
shape, dtype and device under the argument labels -- the axis-level diff
against the entry's previous compile (``diff_signatures``), and
``sig_compiles``: the compiles of that same signature, which is above 1
only when a graph is captured again for inputs it already had (the
thrash that ``python -m lightgbm_tpu_torch obs recompiles --check``
fails on).  The port has no XLA cost analysis: a capture's ``cost`` is
the sum over the kernel launches it recorded of each kernel's count in
``obs/roofline.py`` (``launches_cost``), the bytes and operations
chip_smoke.py's bound column uses; ``costs()`` feeds the roofline
rollup (``utilization_rollup``).

Everything here is best-effort: a signature that cannot be read or a
capture that raises degrades to a smaller event or to no compile, never
to a broken run.
"""
from __future__ import annotations

from dataclasses import fields, is_dataclass

from ..utils.log import Log

# default labels for the top-level positions of a registered entry call
_POS = "a%d"


def _leaf_descr(leaf):
    """(kind, shape, dtype, device) of one flattened argument leaf."""
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is not None and dtype is not None:
        return ("array", tuple(int(d) for d in shape),
                str(dtype).replace("torch.", ""),
                str(getattr(leaf, "device", "")))
    return ("static", (), repr(leaf)[:80], "")


def _flatten(obj, path):
    """(sub-path, leaf) pairs of tensors inside tuples, lists, dicts and
    dataclasses; anything else is one leaf."""
    if isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            yield from _flatten(v, path + "[%d]" % i)
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            yield from _flatten(obj[k], path + "[%r]" % (k,))
    elif is_dataclass(obj) and not isinstance(obj, type):
        for f in fields(obj):
            yield from _flatten(getattr(obj, f.name), path + "." + f.name)
    else:
        yield path, obj


def arg_signature(args, names=None, donate=()):
    """Flatten ``args`` into a tuple of per-leaf descriptors ``(label,
    kind, shape, dtype, donated, device)``: ``label`` is the top-level
    name (``names``, else ``a<i>``) and the leaf's path below it.
    Hashable and order-stable."""
    donate = frozenset(donate)
    sig = []
    for idx, arg in enumerate(tuple(args)):
        top = (names[idx] if names is not None and idx < len(names)
               else _POS % idx)
        for sub, leaf in _flatten(arg, ""):
            kind, shape, dtype, device = _leaf_descr(leaf)
            sig.append((top + sub, kind, shape, dtype, idx in donate,
                        device))
    return tuple(sig)


def render_signature(sig):
    """Compact JSON form: {label: 'float32[2000,8]@cuda:0'}."""
    out = {}
    for label, kind, shape, dtype, donated, device in sig:
        if kind == "array":
            s = "%s[%s]" % (dtype, ",".join(str(d) for d in shape))
            if device:
                s += "@" + device
        else:
            s = "static:%s" % (dtype,)
        if donated:
            s += " (donated)"
        out[label] = s
    return out


def diff_signatures(prev, cur):
    """What changed between two signatures, one dict per change; shape
    changes by axis (``axis``/``before``/``after``), then dtype, device
    and donation."""
    if prev is None:
        return []
    a = {leaf[0]: leaf for leaf in prev}
    b = {leaf[0]: leaf for leaf in cur}
    diff = []
    for label in sorted(a.keys() - b.keys()):
        diff.append({"arg": label, "field": "removed"})
    for label in sorted(b.keys() - a.keys()):
        diff.append({"arg": label, "field": "added", "after":
                     render_signature((b[label],))[label]})
    for label in sorted(a.keys() & b.keys()):
        _, kind_a, shape_a, dtype_a, don_a, dev_a = a[label]
        _, kind_b, shape_b, dtype_b, don_b, dev_b = b[label]
        if kind_a != kind_b:
            diff.append({"arg": label, "field": "kind",
                         "before": kind_a, "after": kind_b})
            continue
        if kind_a == "static":
            if dtype_a != dtype_b:
                diff.append({"arg": label, "field": "value",
                             "before": dtype_a, "after": dtype_b})
            continue
        if len(shape_a) != len(shape_b):
            diff.append({"arg": label, "field": "rank",
                         "before": len(shape_a), "after": len(shape_b)})
        else:
            for axis, (da, db) in enumerate(zip(shape_a, shape_b)):
                if da != db:
                    diff.append({"arg": label, "field": "shape",
                                 "axis": axis, "before": da, "after": db})
        for field, x, y in (("dtype", dtype_a, dtype_b),
                            ("device", dev_a, dev_b),
                            ("donated", don_a, don_b)):
            if x != y:
                diff.append({"arg": label, "field": field, "before": x,
                             "after": y})
    return diff


def format_diff(d):
    """One change dict -> one human-readable clause."""
    arg = d.get("arg", "?")
    field = d.get("field", "?")
    if field == "shape":
        return "%s.shape[%d]: %s -> %s" % (arg, d.get("axis", -1),
                                           d.get("before"), d.get("after"))
    if field == "program":
        return d.get("note", "program rebuilt")
    if field in ("added", "removed"):
        return "%s %s" % (arg, field)
    return "%s.%s: %s -> %s" % (arg, field, d.get("before"),
                                d.get("after"))


def _library_loads():
    from .. import _build
    return _build.loads


class CompileTracker:
    """Per-entry compile state, fed by the observer's ``capture`` hook
    and by ``entry_args`` (before a call) / ``entry_end`` (after)."""

    def __init__(self, registry=None):
        if registry is None:
            from .metrics import REGISTRY
            registry = REGISTRY
        self._registry = registry
        self._entries = {}        # name -> state dict
        self._pending = {}        # name -> (sig, library loads before)

    def _state(self, name):
        return self._entries.setdefault(name, {
            "calls": 0, "compiles": 0, "sig_compiles": {},
            "last_compiled_sig": None})

    def before_call(self, name, args, names=None):
        try:
            sig = arg_signature(args, names=names)
        except Exception as e:    # never break the call
            Log.debug("obs: signature of entry %s unreadable: %s", name, e)
            self._pending.pop(name, None)
            return
        self._pending[name] = (sig, _library_loads())

    def after_call(self, name, obs):
        """A call of the entry ended: a compile when the kernel library
        was first built and loaded during it."""
        pending = self._pending.pop(name, None)
        if pending is None:
            return
        sig, loads0 = pending
        st = self._state(name)
        st["calls"] += 1
        if _library_loads() > loads0:
            self._compiled(name, st, sig, obs,
                           {"field": "program",
                            "note": "kernel library built and loaded"})

    def record_capture(self, name, args, obs, names=None, cost=None):
        """A CUDA graph of entry ``name`` was captured over ``args``."""
        try:
            sig = arg_signature(args, names=names)
        except Exception as e:
            Log.debug("obs: signature of capture %s unreadable: %s", name,
                      e)
            sig = ()
        st = self._state(name)
        st["calls"] += 1
        if cost:
            # the roofline join reads the cost of the entry's last
            # capture (obs/roofline.py utilization_rollup)
            st["last_cost"] = dict(cost)
        self._compiled(name, st, sig, obs, None, cost)

    def _compiled(self, name, st, sig, obs, note, cost=None):
        st["compiles"] += 1
        n_sig = st["sig_compiles"].get(sig, 0) + 1
        st["sig_compiles"][sig] = n_sig
        diff = diff_signatures(st["last_compiled_sig"], sig)
        if note is not None:
            diff.insert(0, note)
        st["last_compiled_sig"] = sig
        fields_ = {"entry": name, "n_compiles": st["compiles"],
                   "sig": render_signature(sig), "sig_compiles": n_sig,
                   "diff": diff}
        if cost:
            fields_["cost"] = dict(cost)
        obs.event("compile_attr", **fields_)
        labels = {"entry": name}
        self._registry.counter(
            "lgbm_entry_compiles_total",
            "compiles (graph captures, the kernels' first build) per "
            "entry point", labels=labels).inc()
        if cost and "flops" in cost:
            self._registry.gauge(
                "lgbm_entry_flops",
                "operations of the kernel launches the entry's last "
                "capture recorded", labels=labels).set(cost["flops"])
        if n_sig > 1:
            Log.warning("obs: entry %s compiled a signature it already "
                        "compiled (%d times): graph re-capture thrash",
                        name, n_sig)
        elif st["compiles"] > 1:
            Log.warning("obs: entry %s compiled again (compile #%d): %s",
                        name, st["compiles"],
                        "; ".join(format_diff(d) for d in diff)
                        or "signature unchanged")

    def costs(self):
        """{entry: cost} of each entry's last capture, rolled up as
        obs/roofline.py ``roll_up_costs`` does for a timeline."""
        from .roofline import roll_up_costs
        return roll_up_costs({name: st["last_cost"]
                              for name, st in self._entries.items()
                              if st.get("last_cost")})

    def summary(self):
        """Folded into run_end: per-entry compile, call and signature
        counts."""
        out = {}
        for name, st in self._entries.items():
            out[name] = {
                "calls": st["calls"],
                "compiles": st["compiles"],
                "signatures": len(st["sig_compiles"]),
                "max_sig_compiles": max(st["sig_compiles"].values(),
                                        default=0),
            }
        return out
