"""The host-sync pass: implicit device->host waits in hot-path modules.

The JAX package's ``analysis/hostsync.py`` on torch values.  CUDA
launches are asynchronous; a read of a device value on the host
(``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
``float/int/bool(tensor)``, ``np.asarray(tensor)``) waits for every
launch before it, and ``torch.cuda.synchronize()`` or an event's or a
stream's ``.synchronize()`` waits by definition.  The runtime audit
(``obs/timers.fence_count``) counts the waits that go through
``obs/timers.fence`` and ``fenced_get``, the sanctioned spellings, which
this pass never flags; it proves the rest of the hot path adds none that
is not routed through them or suppressed with its reason.

Taint model (first order, one forward sweep a scope, as the JAX pass):
a name is a *device value* when it was assigned from an expression
rooted at a ``torch.`` call that makes a tensor on a device (a torch
function of tensors, a factory such as ``torch.empty`` given a
``device=``, ``.cuda()`` or ``.to(device=)``; not the host-returning
calls: ``torch.cuda.*``, ``torch.device``, ``torch.finfo``, ...), or
derived from another device value by attribute, index, arithmetic or a
method, except shape, dtype and device metadata (``.shape``,
``.numel()``, ``.size()``, ...), which the host keeps.  A factory with
no device makes a host tensor (a pinned staging buffer).  The sweep is
flow-sensitive in source order: a use at line N sees only the taints of
the assignments above it, and a host value assigned to a name clears its
taint.  Function parameters are not tainted: precision over recall.
The reads fire only on values the sweep proves device values; the
``synchronize`` calls fire unconditionally.
"""
from __future__ import annotations

import ast
from typing import List, Set

from .core import Finding, SourceModule, dotted_name

PASS_NAME = "hostsync"

RULES = {
    "sync-item":
        ".item() on a device value waits for the launch queue",
    "sync-tolist":
        ".tolist() on a device value waits and copies to the host",
    "sync-cpu":
        ".cpu() on a device value waits and copies to the host",
    "sync-numpy":
        ".numpy() on a device value (a host view that needs the value "
        "on the host)",
    "sync-scalar-cast":
        "float()/int()/bool() on a device value is an implicit wait",
    "sync-asarray":
        "np.asarray/np.array on a device value is an implicit "
        "device->host copy",
    "sync-synchronize":
        "torch.cuda.synchronize() or an event's or stream's "
        ".synchronize() in a hot-path module; route it through "
        "obs/timers.fence so the wait is counted",
}

_NP_NAMES = {"np", "numpy", "onp"}
# torch entry points that return host objects, not tensors
_HOST_TORCH = ("torch.cuda.", "torch.backends.", "torch.distributed.",
               "torch.profiler.", "torch.utils.", "torch.version.",
               "torch._C.", "torch.library.", "torch.autograd.")
_HOST_TORCH_NAMES = {
    "torch.device", "torch.dtype", "torch.finfo", "torch.iinfo",
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.get_num_threads", "torch.set_num_threads", "torch.no_grad",
    "torch.inference_mode", "torch.Generator", "torch.get_default_dtype",
    "torch.promote_types", "torch.result_type", "torch.Size",
    "torch.manual_seed", "torch.set_grad_enabled", "torch.compile",
    "torch.are_deterministic_algorithms_enabled",
    "torch.use_deterministic_algorithms", "torch.cuda",
}
# the methods that read the value to the host (each its own rule) and
# the ones that return host metadata
_READS = {"item": "sync-item", "tolist": "sync-tolist",
          "cpu": "sync-cpu", "numpy": "sync-numpy"}
_HOST_META_METHODS = {"numel", "size", "dim", "element_size", "stride",
                      "data_ptr", "is_contiguous", "storage_offset",
                      "get_device", "nelement", "ndimension",
                      "is_floating_point", "untyped_storage"}
_HOST_META_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda",
                    "nbytes", "itemsize", "layout", "requires_grad",
                    "is_sparse", "names"}
# the counted waits (obs/timers): sanctioned, host-returning
_SANCTIONED = {"fenced_get", "fence"}


# the factories, which make a host tensor unless given a device
_FACTORIES = {"torch.empty", "torch.zeros", "torch.ones", "torch.full",
              "torch.arange", "torch.linspace", "torch.tensor",
              "torch.as_tensor", "torch.from_numpy", "torch.empty_strided",
              "torch.eye", "torch.rand", "torch.randn", "torch.randint",
              "torch.randperm"}


def _is_torch_tensor_call(node: ast.Call, name: str) -> bool:
    """A torch call that makes a device tensor: any torch function of
    tensors, or a factory given a device (not the literal "cpu")."""
    if not name.startswith("torch.") or name in _HOST_TORCH_NAMES:
        return False
    if name.startswith(_HOST_TORCH):
        return False
    if name in _FACTORIES:
        return _has_device_kw(node)
    return True


def _has_device_kw(node: ast.Call) -> bool:
    for kw in node.keywords:
        if kw.arg == "device":
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value == "cpu")
    return False


def _is_device_expr(node: ast.AST, tainted: Set[str]) -> bool:
    """Can this expression be proven to produce a torch device value?"""
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Attribute):
        if node.attr in _HOST_META_ATTRS:
            return False
        return _is_device_expr(node.value, tainted)
    if isinstance(node, (ast.Subscript, ast.Starred)):
        return _is_device_expr(node.value, tainted)
    if isinstance(node, ast.BinOp):
        return (_is_device_expr(node.left, tainted)
                or _is_device_expr(node.right, tainted))
    if isinstance(node, ast.UnaryOp):
        return _is_device_expr(node.operand, tainted)
    if isinstance(node, ast.IfExp):
        return (_is_device_expr(node.body, tainted)
                or _is_device_expr(node.orelse, tainted))
    if isinstance(node, ast.Compare):
        # comparisons of device values are device bools
        return (_is_device_expr(node.left, tainted)
                or any(_is_device_expr(c, tainted)
                       for c in node.comparators))
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        if name and name.rsplit(".", 1)[-1] in _SANCTIONED:
            return False             # the counted read lands on the host
        if name and _is_torch_tensor_call(node, name):
            return True
        if isinstance(node.func, ast.Attribute):
            # a method of a device value: x.sum() stays on the device;
            # the reads and the metadata land on the host; .cuda() and
            # .to(device) move a tensor there
            attr = node.func.attr
            if attr in _READS or attr in _HOST_META_METHODS:
                return False
            if attr == "cuda" or (attr == "to" and _has_device_kw(node)):
                return True
            return _is_device_expr(node.func.value, tainted)
    return False


def walk_scope(body: List[ast.stmt]):
    """Every node of these statements, without descending into nested
    function definitions (each nested scope is swept on its own, with its
    own taints)."""
    stack: List[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        # a class body runs in the enclosing scope (its methods are
        # still scopes of their own)
        stack.extend(ast.iter_child_nodes(node))


def _apply_assign(node: ast.AST, tainted: Set[str]) -> None:
    """Update the taints for one assignment: a host value assigned to a
    simple name clears its taint (the sweep is flow-sensitive)."""
    if isinstance(node, ast.Assign):
        value, targets = node.value, node.targets
    elif isinstance(node, ast.AnnAssign) and node.value:
        value, targets = node.value, [node.target]
    elif isinstance(node, ast.AugAssign):
        value, targets = node.value, [node.target]
    else:
        return
    device = _is_device_expr(value, tainted)
    for t in targets:
        if isinstance(t, ast.Name):
            if device:
                tainted.add(t.id)
            elif not isinstance(node, ast.AugAssign):
                tainted.discard(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)) and device:
            # a device value unpacked: every name is one
            for el in t.elts:
                if isinstance(el, ast.Name):
                    tainted.add(el.id)


def _scan_scope(mod: SourceModule, body: List[ast.stmt],
                findings: List[Finding]) -> None:
    tainted: Set[str] = set()
    nodes = sorted(walk_scope(body),
                   key=lambda n: (getattr(n, "lineno", 0),
                                  getattr(n, "col_offset", 0)))
    for node in nodes:
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            _apply_assign(node, tainted)
            continue
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        if name and name.rsplit(".", 1)[-1] in _SANCTIONED:
            continue                 # obs/timers' counted wait
        func = node.func
        # -- the waits by definition
        if name == "torch.cuda.synchronize" or (
                isinstance(func, ast.Attribute)
                and func.attr == "synchronize"):
            findings.append(Finding(
                "sync-synchronize", PASS_NAME, mod.path, node.lineno,
                "an explicit wait for the device on the hot path",
                "use obs/timers.fence(value) so the wait is counted, or "
                "move it off the hot path"))
            continue
        # -- the reads of proven device values
        if isinstance(func, ast.Attribute) and func.attr in _READS \
                and not node.args \
                and _is_device_expr(func.value, tainted):
            findings.append(Finding(
                _READS[func.attr], PASS_NAME, mod.path, node.lineno,
                ".%s() on a device value waits for the launch queue"
                % func.attr,
                "keep the value on the device, or read it through "
                "obs/timers.fenced_get"))
            continue
        if isinstance(func, ast.Name) \
                and func.id in ("float", "int", "bool") \
                and len(node.args) == 1 \
                and _is_device_expr(node.args[0], tainted):
            findings.append(Finding(
                "sync-scalar-cast", PASS_NAME, mod.path, node.lineno,
                "%s() on a device value is an implicit wait" % func.id,
                "keep the scalar on the device (torch.where) or read it "
                "through fenced_get"))
            continue
        root = name.split(".", 1)[0] if name else ""
        if root in _NP_NAMES and name.endswith((".asarray", ".array")) \
                and node.args and _is_device_expr(node.args[0], tainted):
            findings.append(Finding(
                "sync-asarray", PASS_NAME, mod.path, node.lineno,
                "%s on a device value is an implicit device->host copy"
                % name,
                "stay in torch, or read once at a fenced boundary"))


def run(modules: List[SourceModule], repo_root: str) -> List[Finding]:
    findings: List[Finding] = []
    for mod in modules:
        if not mod.in_hot_path():
            continue
        scopes: List[List[ast.stmt]] = [mod.tree.body]
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes.append(node.body)
        for body in scopes:
            _scan_scope(mod, body, findings)
    return findings
