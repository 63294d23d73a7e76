"""The shared-memory pass: the kernels' launch planners over the
autotuner's shape grid, against the H100's shared memory.

The counterpart of the JAX package's ``analysis/vmem.py``, which sweeps
its Pallas tile planners against the TPU's VMEM: this pass imports the
port's planners -- ``ops/wave_kernels.py hist_plan`` (B1, B3, B4, and
B5 where one block cannot hold its cells) and ``bin_tiles``,
``ops/leaf_hist.py leaf_plan`` (B5's one-scan kernel: one block holding
a leaf's (F, B, 3) cells) and ``ops/sparse_mxu.py launch_plan`` (B6) --
and evaluates them on the CPU
over the grid the autotuner and the binner produce: columns 8, 28, 40,
136, 700, 968 and 2000, bins 16 to 65,536 (1023 and 16383 among them),
child slots from the wave-width ladder (and K = 1, the root and B5), in
the byte, 4-bit packed, uint16 and f64 forms.  Invariants:

* ``smem-budget``   -- a plan's dynamic shared memory exceeds the
  planners' budget (``wave_kernels._SMEM_BUDGET``) or the 232,448 bytes
  an H100 block may opt into;
* ``smem-resident`` -- a plan leaves an SM no room for one resident
  block (``_SMEM_PER_SM`` against the plan's bytes and its static
  shared memory);
* ``smem-bin-tiles`` -- a dense plan's bin tiles do not cover [0, B)
  exactly once.

A slot-ordered dense plan (``hist_plan`` ``ordered``: wide rows, one
slot resident) counts its kernel's static shared memory (the slot
offsets, ``wave_kernels._ORDERED_STATIC_SMEM``) towards the budget and
the SM.  B6 tiles its bin axis past one (slot, B, 3) row (B > 9,044) and
plans every B up to 65,536 (``launch_plan``); its sweep covers them all.
Findings anchor at the planner's ``def`` line, so an inline suppression
there covers a deliberate regime.
"""
from __future__ import annotations

import ast
from typing import List

from .core import Finding, SourceModule

PASS_NAME = "smem"

RULES = {
    "smem-budget":
        "a kernel launch plan claims more dynamic shared memory than "
        "its budget or the H100's per-block opt-in",
    "smem-resident":
        "a kernel launch plan leaves an SM no room for one resident "
        "block",
    "smem-bin-tiles":
        "a dense launch plan's bin tiles do not cover [0, B) exactly "
        "once",
}

N_ROWS = 1 << 20
NUM_SMS = 132                           # H100 SXM
# the most dynamic shared memory an H100 block may opt into
H100_SMEM_PER_BLOCK = 232448
NCOLS_GRID = (8, 28, 40, 136, 700, 968, 2000)
NUM_BINS_GRID = (16, 63, 64, 255, 256, 1023, 1024, 4096, 16383, 65536)
# the wave-width ladder (the auto widths 8/16/32, width 1 of the
# order-sensitive configs, the autotuner's doubling to 64) and K = 1
K_GRID = (1, 8, 16, 32, 64)
# (form, packed, wide): the dense kernels' bin forms; uint16 bins share
# the byte form's plan (the bins' width changes no shared memory)
FORMS = (("byte", False, False), ("packed", True, False),
         ("uint16", False, False), ("f64", False, True))


def _def_line(modules: List[SourceModule], path_suffix: str,
              func_name: str) -> int:
    for mod in modules:
        if not mod.path.endswith(path_suffix):
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.FunctionDef) \
                    and node.name == func_name:
                return node.lineno
    return 0


def _form_bins(form: str):
    """The bin counts a form takes: packed <= 16, byte <= 256, uint16
    above 256, f64 any."""
    if form == "packed":
        return [b for b in NUM_BINS_GRID if b <= 16]
    if form == "byte":
        return [b for b in NUM_BINS_GRID if b <= 256]
    if form == "uint16":
        return [b for b in NUM_BINS_GRID if b > 256]
    return list(NUM_BINS_GRID)


def _covers_once(tiles, B: int) -> bool:
    """Whether the [lo, hi) tiles cover [0, B) once, in order."""
    at = 0
    for lo, hi in tiles:
        if lo != at or hi <= lo:
            return False
        at = hi
    return at == B


def _check_dense(modules, findings) -> None:
    from ..ops import wave_kernels as wk

    path = "lightgbm_tpu_torch/ops/wave_kernels.py"
    line = _def_line(modules, "ops/wave_kernels.py", "hist_plan")
    budget = min(wk._SMEM_BUDGET, H100_SMEM_PER_BLOCK)
    for form, packed, wide in FORMS:
        for F in NCOLS_GRID:
            for B in _form_bins(form):
                for K in K_GRID:
                    _, groups, _, ks, fs, copies, smem, ordered = \
                        wk.hist_plan(F, N_ROWS, B, K, NUM_SMS, packed, wide)
                    where = ("%s form, F=%d B=%d K=%d (KS=%d FS=%d "
                             "copies=%d%s)" % (form, F, B, K, ks, fs, copies,
                                               ", ordered" if ordered
                                               else ""))
                    # the ordered pass's slot offsets
                    static = wk._ORDERED_STATIC_SMEM if ordered else 0
                    if (smem > budget
                            or smem + static > H100_SMEM_PER_BLOCK):
                        findings.append(Finding(
                            "smem-budget", PASS_NAME, path, line,
                            "histogram block claims %d bytes > %d at %s"
                            % (smem, budget, where),
                            "shrink the copies, slots or features a "
                            "block holds, or tile the bins"))
                    if wk._SMEM_PER_SM // (smem + static + 1024) < 1:
                        findings.append(Finding(
                            "smem-resident", PASS_NAME, path, line,
                            "no block of %d bytes is resident on an SM "
                            "at %s" % (smem + static, where),
                            "keep one block within _SMEM_PER_SM"))
                    tiles = wk.bin_tiles(F, B, groups, fs, packed)
                    if not _covers_once(tiles, B):
                        findings.append(Finding(
                            "smem-bin-tiles", PASS_NAME, path, line,
                            "bin tiles %s do not cover [0, %d) once at "
                            "%s" % (tiles[:4], B, where),
                            "derive the tiles as the kernel does "
                            "(csrc/wave_fused.cu bin_tile)"))


def _check_sparse(modules, findings) -> None:
    from ..ops import sparse_mxu as sm
    from ..ops import wave_kernels as wk
    from ..utils.log import LightGBMError

    path = "lightgbm_tpu_torch/ops/sparse_mxu.py"
    line = _def_line(modules, "ops/sparse_mxu.py", "launch_plan")
    budget = min(wk._SMEM_BUDGET, H100_SMEM_PER_BLOCK)
    for B in NUM_BINS_GRID:
        for K in K_GRID:
            try:
                ks, threads, smem, tiles = sm.launch_plan(B, K)
            except LightGBMError as e:
                findings.append(Finding(
                    "smem-budget", PASS_NAME, path, line,
                    "B6 plans no block at B=%d K=%d: %s" % (B, K, e),
                    "tile the bins"))
                continue
            where = ("B=%d K=%d (KS=%d, %d threads, %d bin tiles)"
                     % (B, K, ks, threads, tiles))
            if smem > budget:
                findings.append(Finding(
                    "smem-budget", PASS_NAME, path, line,
                    "B6 block claims %d bytes > %d at %s"
                    % (smem, budget, where),
                    "split the child slots over more slices"))
            if wk._SMEM_PER_SM // (smem + 1024) < 1:
                findings.append(Finding(
                    "smem-resident", PASS_NAME, path, line,
                    "no B6 block of %d bytes is resident on an SM at %s"
                    % (smem, where),
                    "keep one block within _SMEM_PER_SM"))


def _check_leaf(modules, findings) -> None:
    from ..ops import leaf_hist as lh
    from ..ops import wave_kernels as wk

    path = "lightgbm_tpu_torch/ops/leaf_hist.py"
    line = _def_line(modules, "ops/leaf_hist.py", "leaf_plan")
    budget = min(lh.LEAF_SMEM_BUDGET, H100_SMEM_PER_BLOCK)
    for form, packed, wide in FORMS:
        if packed:                      # B5 takes no packed bins
            continue
        for F in NCOLS_GRID:
            for B in _form_bins(form):
                plan = lh.leaf_plan(F, B, wide)
                if not plan.fused:      # B4's plan, swept above
                    continue
                where = "%s form, F=%d B=%d" % (form, F, B)
                used = plan.smem + lh.LEAF_STATIC_SMEM
                if plan.smem > budget or used > H100_SMEM_PER_BLOCK:
                    findings.append(Finding(
                        "smem-budget", PASS_NAME, path, line,
                        "B5 block claims %d bytes (%d with its static "
                        "shared memory) > %d at %s"
                        % (plan.smem, used, budget, where),
                        "leave the shape to B4's plan"))
                if wk._SMEM_PER_SM // (used + 1024) < 1:
                    findings.append(Finding(
                        "smem-resident", PASS_NAME, path, line,
                        "no B5 block of %d bytes is resident on an SM at %s"
                        % (used, where),
                        "keep one block within _SMEM_PER_SM"))


def run(modules: List[SourceModule], repo_root: str) -> List[Finding]:
    findings: List[Finding] = []
    _check_dense(modules, findings)
    _check_leaf(modules, findings)
    _check_sparse(modules, findings)
    return list(dict.fromkeys(findings))
