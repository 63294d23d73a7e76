"""Measured kernel autotuner.

The port's copy of the JAX package's ``ops/autotune.py``: selection is
one decision function (``decide``) that treats the hand-set resolution
of the learner (the histogram kernel, the wave width, the precision,
compaction, fused or staged) as the *prior*, enumerates the prior and
its single-step neighbours along each dimension the user left open,
probes each cell for a few trees on the card with the learner's uploaded
bins, takes the fastest and keeps it in an on-disk cache keyed by
(device kind, schema rev, shape bucket), so later runs of the same
shape pay no probing.  The cache file is the JAX package's format, key
and file name: either package reads the other's entries.

Pins are correctness constraints, never candidates: an explicit user
choice of a dimension, and the width-1 quality pin of the
order-sensitive configs under batched order (``resolve_wave_width``),
exclude that dimension from tuning and are re-applied to cached
winners.

Modes (``tpu_autotune``):

- ``off``     -- prior only; no cache read, no probes (the default).
- ``prior``   -- a cached winner where there is one, else the prior;
                never probes.
- ``measure`` -- a cached winner, else probe the candidates and keep the
                winner.
- ``force``   -- always probe, and overwrite the cache entry.

A probe needs the card: on the CPU ``measure`` and ``force`` are the
prior, unless a test installs a bench function or forces probing
(``install_probe_hooks``).  One ``autotune_decision`` event records each
learner construction's decision, whatever the mode, and one
``autotune_probe`` event each measured cell with its seconds a probe run
(``s_per_wave``, the JAX package's name: one probe run grows one tree)
and its roofline stamp (obs/roofline.py).  The learner queues them until
its observer is attached.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from ..utils.config import Config
from ..utils.log import Log

WAVE_ONLY_MODES = ("pallas_t", "pallas_ct")

# The JAX package gates each candidate on its TPU kernels' VMEM budget
# (its WAVE_VMEM_GATE, 64 MB of accumulator block): a larger block does
# not compile there.  The port's kernels tile any column count and any
# bin count into shared memory (ops/wave_kernels.py hist_plan: feature
# groups and copies of the block histogram sized to the SM), so no cell
# is too large for them; the only gate is the widths the port's growers
# run, 1 <= W <= MAX_WAVE_WIDTH.
MAX_WAVE_WIDTH = 64

# the ncols * bin_pad bound under which the prior takes the fused wave
# kernel (B1, pallas_ct) over the histogram-only one (B3, pallas_t): the
# JAX package's measured bound, a prior and not a gate, so measure mode
# probes ct beyond it
CT_PROMOTION_BOUND = 2560

# bump when the meaning of a cached cell changes: old entries carry the
# old rev in their key and stop matching, and load_cache drops whole
# files written at another rev.  The JAX package's rev: the two share
# the cache format.
CACHE_SCHEMA_REV = 2

# enumeration cap: the prior and its single-step neighbours
MAX_CELLS = 6

_CACHE_ENV = "LGBM_TPU_COMPILE_CACHE"
_CACHE_DIR_NAME = "lgbm_tpu_xla_cache"
_CACHE_FILENAME = "autotune_cache.json"


def _order_sensitive(config: Config) -> bool:
    """Configs whose quality depends on the leaf-wise split order
    (lambdarank; the dart, goss and infinite boosting modes)."""
    return (str(config.objective) in ("lambdarank", "rank")
            or str(config.boosting_type) in ("dart", "goss", "infinite",
                                             "infiniteboost"))


def resolve_wave_order(config: Config) -> str:
    """tpu_wave_order: auto -> 'exact' for the order-sensitive configs,
    'batched' otherwise."""
    v = str(config.tpu_wave_order).strip().lower()
    if v not in ("auto", "batched", "exact"):
        Log.fatal("Unknown tpu_wave_order %s (expected auto/batched/"
                  "exact)", v)
    if v != "auto":
        return v
    return "exact" if _order_sensitive(config) else "batched"


def resolve_wave_width(config: Config, num_leaves: int,
                       wave_order: str = "batched") -> int:
    """tpu_wave_width=-1 -> the auto ladder: 8, 16 or 32 by the leaf
    count, and width 1 for an order-sensitive config under batched order
    (its waves would change the split order).  Explicit widths pass
    through."""
    w = int(config.tpu_wave_width)
    if w > 0:
        return w
    if w != -1:
        Log.fatal("tpu_wave_width must be positive or -1 (auto), got %d", w)
    if _order_sensitive(config) and wave_order != "exact":
        return 1
    if num_leaves <= 31:
        return 8
    if num_leaves <= 127:
        return 16
    return 32


def bin_pad(num_bins: int) -> int:
    """The JAX package's padded bin width a feature (its ops/wave.py)."""
    if num_bins <= 64:
        return 64
    return ((num_bins + 127) // 128) * 128


def prior_hist_mode(ncols: int, bin_pad_: int) -> str:
    """The prior transposed wave kernel: the fused one (B1) while the
    accumulator block is narrow, the histogram-only one (B3) with a
    separate partition above CT_PROMOTION_BOUND."""
    return ("pallas_ct" if ncols * bin_pad_ <= CT_PROMOTION_BOUND
            else "pallas_t")


def prior_hist_hilo(config: Config) -> bool:
    """tpu_hist_precision: False (the single bf16 product) for bf16, else
    True.  The JAX package's auto takes bf16 under wave growth on the
    TPU, where the bf16 matrix unit halves the histogram's work; the
    port's kernels sum in 64-bit fixed point, on which rounding the
    weights saves nothing, so its prior stays on the unrounded weights
    on every device (ROADMAP.md, "Precision"), and bf16 is a neighbour
    measure mode probes."""
    return str(config.tpu_hist_precision).strip().lower() != "bf16"


def row_bucket(num_data: int) -> int:
    """Shape-bucket N: the next power of two >= num_data."""
    n, b = max(int(num_data), 1), 1
    while b < n:
        b <<= 1
    return b


class Cell(NamedTuple):
    """One point of the kernel design space."""
    hist_mode: str      # pallas_t / pallas_ct
    wave_width: int     # W
    hist_hilo: bool     # True = unrounded weights, False = the bf16 form
    compact: bool       # frontier compaction (tpu_wave_compact)
    fused: bool = False  # the fused iteration's graphs, or staged

    def as_dict(self) -> dict:
        return {"hist_mode": self.hist_mode,
                "wave_width": int(self.wave_width),
                "hist_hilo": bool(self.hist_hilo),
                "compact": bool(self.compact),
                "fused": bool(self.fused)}

    @classmethod
    def from_dict(cls, d: dict) -> "Cell":
        return cls(str(d["hist_mode"]), int(d["wave_width"]),
                   bool(d["hist_hilo"]), bool(d["compact"]),
                   bool(d.get("fused", False)))


class ShapeBucket(NamedTuple):
    """The cache/decision key: device columns, padded bins a column,
    leaves, and the power-of-two row bucket."""
    ncols: int
    bin_pad: int
    num_leaves: int
    n_bucket: int

    def key(self) -> str:
        return "c%d_b%d_l%d_n%d" % self


class Pins(NamedTuple):
    """Dimensions excluded from tuning (True = pinned)."""
    kernel: bool = False
    width: bool = False
    precision: bool = False
    compact: bool = False
    fused: bool = False


class Decision(NamedTuple):
    """What ``decide`` resolved, and its trail: ``events`` is a list of
    (ev, fields) the caller queues on its observer."""
    cell: Cell
    mode: str            # off / prior / measure / force
    source: str          # off / ineligible / prior / cache / measured
    bucket: str
    probes: Tuple        # ((Cell, s_per_wave), ...) measured this call
    margin: float        # runner-up's s/wave over the winner's, minus 1
    overhead_s: float    # probe seconds paid in this construction
    cache_hit: bool
    events: List


def resolve_mode(config: Config) -> str:
    v = str(config.tpu_autotune).strip().lower()
    if v not in ("off", "prior", "measure", "force"):
        Log.fatal("Unknown tpu_autotune %s (expected off/prior/measure/"
                  "force)", config.tpu_autotune)
    return v


def resolve_cache_path(config: Config) -> str:
    """``tpu_autotune_cache`` when set, else ``autotune_cache.json`` in
    ``$LGBM_TPU_COMPILE_CACHE``, else in ``lgbm_tpu_xla_cache`` under the
    temporary directory (the JAX package's defaults)."""
    p = str(config.tpu_autotune_cache).strip()
    if p:
        return p
    root = (os.environ.get(_CACHE_ENV)
            or os.path.join(tempfile.gettempdir(), _CACHE_DIR_NAME))
    return os.path.join(root, _CACHE_FILENAME)


def cache_key(device_kind: str, bucket: ShapeBucket) -> str:
    return "%s|v%d|%s" % (device_kind, CACHE_SCHEMA_REV, bucket.key())


def load_cache(path: str) -> dict:
    """The cache file's entries; a missing or corrupt file, or one written
    at another CACHE_SCHEMA_REV, is an empty cache (so store_cache never
    merges stale entries into a file of the current rev)."""
    try:
        with open(path) as f:
            data = json.load(f)
        if data.get("version") != CACHE_SCHEMA_REV:
            return {}
        entries = data.get("entries", {})
        return entries if isinstance(entries, dict) else {}
    except (OSError, ValueError, AttributeError):
        return {}


def store_cache(path: str, key: str, entry: dict) -> bool:
    """Merge ``key: entry`` into the cache file atomically (a temporary
    file and os.replace).  False, without raising, when the directory is
    not writable."""
    try:
        entries = load_cache(path)
        entries[key] = entry
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp.%d" % os.getpid()
        with open(tmp, "w") as f:
            json.dump({"version": CACHE_SCHEMA_REV, "entries": entries},
                      f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return True
    except OSError as e:
        Log.warning("autotune cache not persisted to %s (%s); this run "
                    "keeps its measured cell, the next run re-probes",
                    path, e)
        return False


def apply_pins(cell: Cell, prior: Cell, pins: Pins) -> Cell:
    """Pinned dimensions always take the prior's value."""
    return Cell(
        hist_mode=prior.hist_mode if pins.kernel else cell.hist_mode,
        wave_width=prior.wave_width if pins.width else cell.wave_width,
        hist_hilo=prior.hist_hilo if pins.precision else cell.hist_hilo,
        compact=prior.compact if pins.compact else cell.compact,
        fused=prior.fused if pins.fused else cell.fused)


def enumerate_cells(prior: Cell, bucket: ShapeBucket, pins: Pins,
                    ct_allowed: bool = True) -> List[Cell]:
    """The candidates, prior first (a tie keeps the prior): the fused /
    staged flip, the width one tier up and down, the other transposed
    kernel, the other precision, compaction on, along each unpinned
    dimension; at most MAX_CELLS.  The JAX package's neighbours in its
    order; where its VMEM gate drops a wide cell, the port keeps it
    (see MAX_WAVE_WIDTH)."""
    if prior.hist_mode not in WAVE_ONLY_MODES:
        return [prior]
    cands: List[Cell] = [prior]
    if not pins.fused:
        cands.append(prior._replace(fused=not prior.fused))
    if not pins.width:
        for w in (prior.wave_width * 2, prior.wave_width // 2):
            if 1 <= w <= MAX_WAVE_WIDTH:
                cands.append(prior._replace(wave_width=w))
    if not pins.kernel:
        alt = {"pallas_t": "pallas_ct",
               "pallas_ct": "pallas_t"}.get(prior.hist_mode)
        if alt and (alt != "pallas_ct" or ct_allowed):
            cands.append(prior._replace(hist_mode=alt))
    if not pins.precision:
        cands.append(prior._replace(hist_hilo=not prior.hist_hilo))
    if not pins.compact and not prior.compact:
        cands.append(prior._replace(compact=True))
    out: List[Cell] = []
    for c in cands:
        if c not in out:
            out.append(c)
    return out[:MAX_CELLS]


# ---------------------------------------------------------------- probing
# injectable measurement hooks: "timer" replaces time.perf_counter,
# "bench" replaces the whole probe by a synthetic (cell, bucket) ->
# s/wave, "force" lets measure mode probe on the CPU; tests install them
_HOOKS = {"timer": None, "bench": None, "force": False}


def install_probe_hooks(timer: Optional[Callable[[], float]] = None,
                        bench: Optional[Callable] = None,
                        force: bool = True) -> None:
    _HOOKS["timer"] = timer
    _HOOKS["bench"] = bench
    _HOOKS["force"] = bool(force)


def clear_probe_hooks() -> None:
    _HOOKS["timer"] = None
    _HOOKS["bench"] = None
    _HOOKS["force"] = False


def probe_available(probe, device=None) -> bool:
    """Probing needs the card (or an installed bench or force hook): on
    the CPU measure mode is the prior, with no probes."""
    if _HOOKS["bench"] is not None:
        return True
    if probe is None:
        return False
    on_card = device is not None and torch.device(device).type == "cuda"
    return on_card or _HOOKS["force"]


def measure_cells(cells: List[Cell], bucket: ShapeBucket, probe,
                  waves: int, events: List, kind: str = "cpu",
                  overrides=None,
                  wide: bool = False) -> List[Tuple[Cell, float]]:
    """Time each candidate: ``probe(cell)`` builds the cell and returns
    a run closure that grows one tree and waits for it (through
    obs/timers.fence); one untimed run first (the warm-up, the graph
    captures of a fused cell), then ``waves`` timed runs, then the
    closure's ``close`` where it has one.  A cell whose
    build or run raises is dropped with a warning: a failed candidate
    never takes training down, the prior still works."""
    timer = _HOOKS["timer"] or time.perf_counter
    bench = _HOOKS["bench"]
    waves = max(1, int(waves))
    out: List[Tuple[Cell, float]] = []
    for cell in cells:
        try:
            if bench is not None:
                s_per_wave = float(bench(cell, bucket))
            else:
                run = probe(cell)
                try:
                    run()                  # warm-up and captures, untimed
                    t0 = timer()
                    for _ in range(waves):
                        run()
                    s_per_wave = (timer() - t0) / waves
                finally:
                    # a fused cell frees its graphs' pools
                    getattr(run, "close", lambda: None)()
        except Exception as e:  # noqa: BLE001 -- any candidate may fail
            Log.warning("autotune probe failed for cell %s on %s (%s); "
                        "candidate dropped", cell, bucket.key(), e)
            continue
        events.append(("autotune_probe", {
            "bucket": bucket.key(), "cell": cell.as_dict(),
            "waves": waves, "s_per_wave": s_per_wave,
            "roofline": _cell_roofline(bucket, cell, s_per_wave, kind,
                                       overrides, wide)}))
        out.append((cell, s_per_wave))
    return out


def _cell_roofline(bucket: ShapeBucket, cell: Cell, s_per_wave: float,
                   kind: str, overrides=None, wide: bool = False):
    """The roofline stamp of one probed cell (obs/roofline.py; wide: the
    f64 form's bytes); best-effort: attribution never fails a probe."""
    try:
        from ..obs.roofline import cell_roofline
        return cell_roofline(bucket, cell, s_per_wave, kind=kind,
                             overrides=overrides, wide=wide)
    except Exception:  # noqa: BLE001 -- the stamp is telemetry
        return None


def decide(config: Config, bucket: ShapeBucket, prior: Cell, pins: Pins,
           eligible: bool, probe=None, ct_allowed: bool = True,
           device=None, wide: bool = False) -> Decision:
    """The kernel-selection decision of one learner construction; always
    carries exactly one ``autotune_decision`` event (plus the probe
    events).  ``device``: the learner's device, whose kind keys the
    cache and whose type says whether probes can run; ``wide``: the
    learner runs the kernels' f64 form (tpu_use_dp), whose roofline
    stamps count float64 bytes."""
    from ..obs.roofline import device_kind, load_peak_overrides
    mode = resolve_mode(config)
    waves = int(config.tpu_autotune_waves)
    if waves <= 0:
        Log.fatal("tpu_autotune_waves must be positive, got %d", waves)
    kind = device_kind(device)
    overrides = load_peak_overrides(str(config.obs_roofline_peaks or ""))
    events: List = []

    def _finish(cell, source, probes=(), margin=0.0, overhead=0.0,
                cache_hit=False, cache_path=""):
        events.append(("autotune_decision", {
            "mode": mode, "source": source, "bucket": bucket.key(),
            "device_kind": kind, "cell": cell.as_dict(),
            "prior": prior.as_dict(),
            "cells": [{"cell": c.as_dict(), "s_per_wave": s,
                       "roofline": _cell_roofline(bucket, c, s, kind,
                                                  overrides, wide)}
                      for c, s in probes],
            "margin": float(margin), "overhead_s": float(overhead),
            "cache_hit": bool(cache_hit), "cache_path": cache_path}))
        return Decision(cell=cell, mode=mode, source=source,
                        bucket=bucket.key(), probes=tuple(probes),
                        margin=float(margin), overhead_s=float(overhead),
                        cache_hit=bool(cache_hit), events=events)

    if mode == "off":
        return _finish(prior, "off")
    if not eligible:
        return _finish(prior, "ineligible")
    path = resolve_cache_path(config)
    key = cache_key(kind, bucket)
    if mode != "force":
        entry = load_cache(path).get(key)
        if entry is not None:
            try:
                cell = apply_pins(Cell.from_dict(entry["cell"]), prior,
                                  pins)
            except (KeyError, TypeError, ValueError):
                cell = None
            if cell is not None:
                return _finish(cell, "cache", cache_hit=True,
                               cache_path=path)
    if mode == "prior" or not probe_available(probe, device):
        return _finish(prior, "prior", cache_path=path)
    cells = enumerate_cells(prior, bucket, pins, ct_allowed=ct_allowed)
    probes = measure_cells(cells, bucket, probe, waves, events, kind,
                           overrides, wide)
    if not probes:
        return _finish(prior, "prior", cache_path=path)
    best = min(probes, key=lambda p: p[1])
    others = sorted(s for c, s in probes if c is not best[0])
    margin = (others[0] / best[1] - 1.0) if others and best[1] > 0 else 0.0
    overhead = sum(s * waves for _, s in probes)
    store_cache(path, key, {
        "cell": best[0].as_dict(), "s_per_wave": best[1],
        "waves": waves,
        "cells": [{"cell": c.as_dict(), "s_per_wave": s}
                  for c, s in probes]})
    return _finish(best[0], "measured", probes=probes, margin=margin,
                   overhead=overhead, cache_path=path)
