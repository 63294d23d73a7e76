"""Roofline attribution: where a measured time sits against the card's
peaks.

The port's copy of the JAX package's ``obs/roofline.py``, cut to what
the autotuner and ``obs explain`` read:

    roof_s   = max(flops / peak_flops, bytes / peak_hbm [, link term])
    flop_util = (flops / peak_flops) / measured_s
    hbm_util  = (bytes / peak_hbm) / measured_s

The peaks are a registry keyed by the normalized device kind
(``torch.cuda.get_device_name`` with spaces as ``_``, lower case).  Its
one card row holds the published figures of the NVIDIA H100 SXM5 80 GB
(NVIDIA's H100 datasheet), not measurements: HBM3 3.35 TB/s, 67 TFLOP/s
of f32 outside the tensor cores, 989 TFLOP/s of dense bf16 on them,
900 GB/s of NVLink and 228 KiB of shared memory a SM (the card's
counterpart of the TPU's VMEM).  chip_smoke.py's bound column reads the
same row, so a kernel's bound and a probe's stamp divide by the same
peaks.  An unknown kind falls back to a deliberately modest CPU profile
with ``source="fallback"``: a wrong but labelled roof still ranks cells
against each other.

``cell_traffic`` counts the work of one autotune probe run (one tree of
the probe's synthetic gradients) with the bytes and adds of the port's
own kernels, the count chip_smoke.py's ``bound`` and PERF.md's bound
column use: B1 (or B3 under ``pallas_t``) once a wave, B3 at the root,
B2 once.  ``launches_cost`` counts a CUDA graph capture's kernel
launches the same way (obs/compile.py: the port's compile-time cost
estimate, with every row in a listed slot, since a capture records no
data); ``timeline_roofline`` and ``render_roofline`` (``python -m
lightgbm_tpu_torch obs roofline``) join those costs with the run's
entry timers, and ``utilization_rollup`` is the per-iteration
``utilization`` event (``obs_utilization_every``).
"""
from __future__ import annotations

import json
import sys

from ..utils.log import Log

# Per-card peaks keyed by normalized device kind.  Fields:
#   flops_f32 / flops_bf16  peak FLOP/s by compute type
#   hbm_bytes_per_s         main-memory bandwidth
#   ici_bytes_per_s         interconnect bandwidth a card (NVLink)
#   smem_bytes_per_sm       on-chip shared memory a SM
DEFAULT_PEAKS = {
    # published figures of the H100 SXM5 80 GB (datasheet), not measured
    "nvidia_h100_80gb_hbm3": {
        "flops_f32": 67e12, "flops_bf16": 989e12,
        "hbm_bytes_per_s": 3.35e12, "ici_bytes_per_s": 900e9,
        "smem_bytes_per_sm": 228 * 2**10,
    },
    # the fallback: a deliberately modest single-socket profile, so CPU
    # runs (the tests) give finite, clearly labelled numbers
    "cpu": {
        "flops_f32": 100e9, "flops_bf16": 100e9,
        "hbm_bytes_per_s": 25e9, "ici_bytes_per_s": 10e9,
        "smem_bytes_per_sm": 32 * 2**20,
    },
}

_KIND_ALIASES = {"cpu_device": "cpu"}

# under this fraction of every roof the time is host orchestration (the
# launches and the host glue), not the device's data path
ORCH_FLOOR = 0.02

BOUNDS = ("compute", "memory", "collective", "host-orchestration")


def normalize_kind(kind):
    """Canonical registry key for a raw device kind string."""
    k = str(kind or "").strip().lower().replace(" ", "_").replace("-", "_")
    return _KIND_ALIASES.get(k, k)


def device_kind(device=None):
    """The autotune cache's device kind: the CUDA card's name with spaces
    as ``_`` (``NVIDIA_H100_80GB_HBM3``), ``cpu`` for a CPU device or
    where there is no card.  ``device``: a torch.device or its string;
    None takes the current CUDA device where there is one."""
    import torch
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    index = device.index if device is not None else None
    return str(torch.cuda.get_device_name(index)).strip().replace(" ", "_")


def load_peak_overrides(path):
    """Parse an ``obs_roofline_peaks`` JSON file: {kind: profile}."""
    if not path:
        return {}
    try:
        with open(path) as f:
            raw = json.load(f)
        return {normalize_kind(k): dict(v) for k, v in raw.items()
                if isinstance(v, dict)}
    except Exception as e:
        Log.warning("obs: roofline peak overrides %s unreadable: %s",
                    path, e)
        return {}


def peaks_for(kind, overrides=None):
    """The peak profile of ``kind`` with its provenance: an exact match
    in ``overrides``, then in the table, then a prefix match against the
    table, else the CPU fallback with ``source="fallback"``."""
    nk = normalize_kind(kind)
    table = dict(DEFAULT_PEAKS)
    for k, v in (overrides or {}).items():
        base = dict(table.get(normalize_kind(k), DEFAULT_PEAKS["cpu"]))
        base.update(v)
        table[normalize_kind(k)] = base
    if nk in table:
        return dict(table[nk], kind=nk,
                    source=("override" if nk in (overrides or {})
                            else "table"))
    for k in table:
        if k != "cpu" and (nk.startswith(k) or k.startswith(nk)) and nk:
            return dict(table[k], kind=k, source="table")
    return dict(table["cpu"], kind=nk or "unknown", source="fallback")


def h100_peaks():
    """(HBM bytes/s, f32 FLOP/s) of the H100 row: the peaks chip_smoke.py
    divides its kernels' bounds by."""
    row = DEFAULT_PEAKS["nvidia_h100_80gb_hbm3"]
    return row["hbm_bytes_per_s"], row["flops_f32"]


def entry_roofline(cost, exec_mean_s, exec_n, peaks, dtype="f32",
                   ici_bytes=0.0, world_size=1):
    """Join one piece of work's cost ({flops, bytes_accessed}, either may
    be missing) with its measured time; with no cost at all it classifies
    as host orchestration at zero utilization."""
    cost = cost or {}
    flops = float(cost.get("flops") or 0.0)
    nbytes = float(cost.get("bytes_accessed") or 0.0)
    ici = float(ici_bytes or 0.0) if int(world_size or 1) > 1 else 0.0
    mean = max(float(exec_mean_s or 0.0), 0.0)
    peak_flops = float(peaks.get("flops_%s" % dtype)
                       or peaks.get("flops_f32") or 1.0)
    peak_hbm = float(peaks.get("hbm_bytes_per_s") or 1.0)
    peak_ici = float(peaks.get("ici_bytes_per_s") or 1.0)
    t_compute = flops / peak_flops
    t_memory = nbytes / peak_hbm
    t_ici = ici / peak_ici
    roof_s = max(t_compute, t_memory, t_ici)
    out = {
        "flops": flops, "bytes_accessed": nbytes,
        "achieved_flops_per_s": (flops / mean) if mean > 0 else 0.0,
        "achieved_bytes_per_s": (nbytes / mean) if mean > 0 else 0.0,
        "ai": (flops / nbytes) if nbytes > 0 else None,
        "flop_util": min(1.0, t_compute / mean) if mean > 0 else 0.0,
        "hbm_util": min(1.0, t_memory / mean) if mean > 0 else 0.0,
        "roof_s": roof_s,
        "headroom_s": max(0.0, mean - roof_s) * max(int(exec_n or 0), 0),
        "exec_mean_s": mean, "exec_n": int(exec_n or 0),
    }
    if ici > 0:
        out["ici_util"] = min(1.0, t_ici / mean) if mean > 0 else 0.0
    fracs = {"compute": out["flop_util"], "memory": out["hbm_util"]}
    if ici > 0:
        fracs["collective"] = out["ici_util"]
    bound = max(fracs, key=lambda k: fracs[k])
    if fracs[bound] < ORCH_FLOOR:
        bound = "host-orchestration"
    out["bound"] = bound
    return out


def _wave_kernel_traffic(n, ncols, bins, slots, n_listed, fused,
                         bin_bytes=1, wide=False):
    """(bytes, adds) of one launch of B1 (fused: the routing pass and the
    histogram pass) or B3 (histogram only) at ``slots`` child slots with
    ``n_listed`` rows in them: chip_smoke.py's bound count.  bin_bytes:
    1 for uint8 bins, 2 for uint16 ones (more than 256 bins); wide: the
    f64 form (float64 weights in, float64 histograms out)."""
    vb = 24 if wide else 12                # a weight row, a histogram bin
    hist = slots * ncols * bins * vb
    if fused:
        nbytes = n * (4 + 4 + bin_bytes) + n_listed * (ncols * bin_bytes
                                                      + vb) \
            + slots * (10 * 4 + 8) + hist
    else:
        nbytes = n * 4 + n_listed * (ncols * bin_bytes + vb) + slots * 4 \
            + hist
    return float(nbytes), float(3 * n_listed * ncols)


def launch_traffic(kernel, n, ncols, bins, slots, bin_bytes=1,
                   wide=False, entries=0, leaves=0):
    """(flops, bytes) of one launch of the port's kernel whose wrapper is
    named ``kernel``, at n rows, ncols columns, bins bins and ``slots``
    child slots, every row in a slot: chip_smoke.py's bound count.
    ``entries``: the sparse store's entries (B6); ``leaves``: the leaf
    values B2 reads."""
    if kernel in ("wave_partition_hist", "wave_histogram",
                  "wave_histogram_rowmajor", "leaf_histogram"):
        nbytes, flops = _wave_kernel_traffic(
            n, ncols, bins, 1 if kernel == "leaf_histogram" else slots, n,
            kernel == "wave_partition_hist", bin_bytes, wide)
        return flops, nbytes
    if kernel == "sparse_wave_histogram":
        # each entry's row, bin, leaf id and weight row, the histograms
        return (3.0 * entries,
                float(entries * (4 + 4 + 4 + 12) + n * 4
                      + slots * ncols * bins * 12))
    if kernel == "score_update":
        return float(n), float(n * 12 + leaves * 4)
    return 0.0, 0.0


def launches_cost(launches, **shape):
    """{flops, bytes_accessed} of the kernel launches {wrapper name:
    count} of one capture, each counted by ``launch_traffic`` at
    ``shape``; None when it launched none."""
    flops = nbytes = 0.0
    for kernel, count in launches.items():
        if count:
            f, b = launch_traffic(kernel, **shape)
            flops += count * f
            nbytes += count * b
    if not flops and not nbytes:
        return None
    return {"flops": flops, "bytes_accessed": nbytes}


def cell_traffic(bucket, cell, wide=False):
    """(flops, bytes) of one probe run of ``cell`` on ``bucket``: a tree
    of ``num_leaves`` leaves grown in waves of width ``wave_width`` on
    ``n_bucket`` rows, with leaves of equal size (a wave's listed rows
    are the splitting leaves' share of the rows): B3 at the root (one
    slot, every row), then per wave B1 (``pallas_ct``) or B3
    (``pallas_t``) at one slot a split, and B2 (the score update, 12
    bytes and an add a row, 4 bytes a leaf).  The bf16 form and
    compaction move the same bytes in the port's kernels.  A bucket of
    more than 256 padded bins reads two-byte bins; wide (tpu_use_dp) is
    the f64 form, whose weights, histograms and scores are float64 (its
    score update is the gather: 20 bytes a row, 8 a leaf)."""
    n = float(getattr(bucket, "n_bucket", 0) or 0)
    ncols = float(getattr(bucket, "ncols", 0) or 0)
    bins = float(getattr(bucket, "bin_pad", 0) or 0)
    leaves_max = int(getattr(bucket, "num_leaves", 2) or 2)
    width = max(int(getattr(cell, "wave_width", 1) or 1), 1)
    fused = getattr(cell, "hist_mode", "") == "pallas_ct"
    form = dict(bin_bytes=2 if bins > 256 else 1, wide=bool(wide))
    nbytes, flops = _wave_kernel_traffic(n, ncols, bins, 1, n, False,
                                         **form)
    leaves = 1
    while leaves < leaves_max:
        splits = min(leaves, width, leaves_max - leaves)
        b, f = _wave_kernel_traffic(n, ncols, bins, splits,
                                    n * splits / leaves, fused, **form)
        nbytes += b
        flops += f
        leaves += splits
    nbytes += n * 20 + leaves_max * 8 if wide else n * 12 + leaves_max * 4
    flops += n
    return flops, nbytes


def cell_roofline(bucket, cell, s_per_wave, kind=None, overrides=None,
                  wide=False):
    """The roofline stamp of one probed autotune cell: where its
    measured seconds a probe run sit against the card's compute and
    memory roofs.  ops/autotune.py attaches it to every
    ``autotune_probe`` event so ``obs explain`` can say why the winner
    won."""
    if kind is None:
        kind = device_kind()
    peaks = peaks_for(kind, overrides)
    flops, nbytes = cell_traffic(bucket, cell, wide)
    r = entry_roofline({"flops": flops, "bytes_accessed": nbytes},
                       s_per_wave, 1, peaks)
    return {"flop_util": round(r["flop_util"], 4),
            "hbm_util": round(r["hbm_util"], 4),
            "ai": round(r["ai"], 3) if r["ai"] else None,
            "bound": r["bound"], "device_kind": peaks.get("kind"),
            "roof_source": peaks.get("source")}


def roll_up_costs(last):
    """{entry: cost} from each entry's last capture cost ``last``, an
    entry ``a.b``'s also counted toward ``a``: the fused iteration's tree
    and score graphs toward ``fused_iter``, the entry its calls time.
    Its tail graph runs only for trees the tree graph did not finish, so
    it does not count."""
    costs = {}
    for name, cost in last.items():
        costs[name] = dict(cost)
        if "." in str(name) and not str(name).endswith(".tail"):
            parent = costs.setdefault(str(name).split(".")[0], {})
            for k, v in cost.items():
                parent[k] = parent.get(k, 0.0) + float(v)
    return costs


def _entry_costs(events):
    """roll_up_costs of the last compile_attr cost of each entry."""
    return roll_up_costs({e.get("entry"): e["cost"] for e in events
                          if e.get("ev") == "compile_attr"
                          and e.get("cost")})


def timeline_roofline(events, overrides=None, peaks_path=""):
    """The roofline join of one run's events (query.last_run first):
    {device_kind, peaks, world_size, rows, problems}, rows ranked by
    headroom (most recoverable seconds first), problems the defects
    ``--check`` fails on."""
    if overrides is None:
        overrides = load_peak_overrides(peaks_path)
    problems = []
    header = next((e for e in events if e.get("ev") == "run_header"), {})
    kind = ""
    for d in header.get("devices") or ():
        if isinstance(d, dict) and d.get("kind"):
            kind = str(d["kind"])
            break
    kind = kind or str(header.get("backend", "") or "")
    world_size = int(header.get("world_size") or 1)
    peaks = peaks_for(kind, overrides)
    run_end = next((e for e in events if e.get("ev") == "run_end"), None)
    entries = (run_end or {}).get("entries") or {}
    if not entries:
        problems.append("no run_end entry stats on the timeline "
                        "(run did not finalize, or never timed an entry)")
    costs = _entry_costs(events)
    if entries and not costs:
        problems.append("no cost estimates on the timeline: run with "
                        "obs_compile=true so compile_attr events carry "
                        "the captures' kernel costs")
    rows = []
    for name, st in entries.items():
        r = entry_roofline(costs.get(name), st.get("exec_mean_s", 0.0),
                           st.get("exec_n", 0), peaks,
                           world_size=world_size)
        r["entry"] = name
        r["has_cost"] = name in costs
        r["exec_total_s"] = float(st.get("exec_total_s", 0.0))
        rows.append(r)
    rows.sort(key=lambda r: -r["headroom_s"])
    return {"device_kind": kind or "unknown", "peaks": peaks,
            "world_size": world_size, "rows": rows, "problems": problems}


def utilization_rollup(entry_summary, costs, peaks, world_size=1):
    """One iteration's ``utilization`` event: the exec-time-weighted
    utilization over the timed entries with a cost, and the bound of the
    entry with the most headroom.  ``entry_summary``: EntryTimers.
    summary(); ``costs``: CompileTracker.costs().  None when no timed
    entry has a cost yet."""
    rows = []
    for name, st in (entry_summary or {}).items():
        if name not in costs:
            continue
        r = entry_roofline(costs.get(name), st.get("exec_mean_s", 0.0),
                           st.get("exec_n", 0), peaks,
                           world_size=world_size)
        r["entry"] = name
        r["weight"] = float(st.get("exec_total_s", 0.0))
        rows.append(r)
    if not rows:
        return None
    wsum = sum(r["weight"] for r in rows) or 1.0
    worst = max(rows, key=lambda r: r["headroom_s"])
    return {
        "flop_util": sum(r["flop_util"] * r["weight"] for r in rows) / wsum,
        "hbm_util": sum(r["hbm_util"] * r["weight"] for r in rows) / wsum,
        "headroom_s": sum(r["headroom_s"] for r in rows),
        "bound": worst["bound"],
        "device_kind": peaks.get("kind", "unknown"),
        "roof_source": peaks.get("source", "fallback"),
        "entries": {r["entry"]: {"flop_util": round(r["flop_util"], 6),
                                 "hbm_util": round(r["hbm_util"], 6),
                                 "bound": r["bound"]}
                    for r in rows},
    }


def fmt_quantity(v, unit=""):
    """Humanize a count into K/M/G/T units (1e9 -> '1.00 G')."""
    v = float(v or 0.0)
    for thresh, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"),
                           (1e3, "K")):
        if abs(v) >= thresh:
            return "%.2f %s%s" % (v / thresh, suffix, unit)
    return "%.3g %s" % (v, unit) if unit else "%.3g" % v


def fmt_bytes(v):
    v = float(v or 0.0)
    for thresh, suffix in ((2**40, "TiB"), (2**30, "GiB"),
                           (2**20, "MiB"), (2**10, "KiB")):
        if abs(v) >= thresh:
            return "%.2f %s" % (v / thresh, suffix)
    return "%d B" % int(v)


def describe_roofline_position(r):
    """One clause for a probe's stamp: '71% HBM' or '12% FLOP' (the
    dominant roof, as obs explain prints it)."""
    if not isinstance(r, dict):
        return ""
    bound = r.get("bound", "")
    if bound == "memory":
        return "%d%% HBM" % round(100 * float(r.get("hbm_util") or 0.0))
    if bound == "compute":
        return "%d%% FLOP" % round(100 * float(r.get("flop_util") or 0.0))
    if bound == "collective":
        return "%d%% NVLink" % round(100 * float(r.get("ici_util") or 0.0))
    if bound:
        top = max(float(r.get("hbm_util") or 0.0),
                  float(r.get("flop_util") or 0.0))
        return "%s, %d%% of roof" % (bound, round(100 * top))
    return ""


def render_roofline(events, out=None, check=False, peaks_path=""):
    """Print the headroom-ranked roofline table of the last run; return
    the problems list (``--check`` exits nonzero when it is not
    empty)."""
    out = out or sys.stdout
    w = lambda s="": print(s, file=out)  # noqa: E731
    res = timeline_roofline(events, peaks_path=peaks_path)
    peaks = res["peaks"]
    w("== roofline: %s (%s peaks%s) ==" % (
        res["device_kind"], peaks.get("source", "?"),
        ", world_size=%d" % res["world_size"]
        if res["world_size"] > 1 else ""))
    w("  peak %sFLOP/s f32, %s/s HBM, %s/s NVLink, %s shared a SM" % (
        fmt_quantity(peaks.get("flops_f32")),
        fmt_bytes(peaks.get("hbm_bytes_per_s")),
        fmt_bytes(peaks.get("ici_bytes_per_s")),
        fmt_bytes(peaks.get("smem_bytes_per_sm"))))
    rows = res["rows"]
    if rows:
        w()
        w("  %-34s %5s %10s %6s %6s %8s %-18s %10s" % (
            "entry", "calls", "mean", "FLOP%", "HBM%", "AI",
            "bound", "headroom"))
        for r in rows:
            w("  %-34s %5d %9.2fms %5.1f%% %5.1f%% %8s %-18s %9.3fs%s" % (
                r["entry"][:34], r["exec_n"], r["exec_mean_s"] * 1e3,
                100 * r["flop_util"], 100 * r["hbm_util"],
                ("%.2f" % r["ai"]) if r["ai"] is not None else "-",
                r["bound"], r["headroom_s"],
                "" if r["has_cost"] else "  (no cost estimate)"))
        total = sum(r["headroom_s"] for r in rows)
        w()
        w("  total headroom %.3fs across %d entries: seconds recoverable"
          " if every entry hit its roof" % (total, len(rows)))
        counts = {}
        for r in rows:
            counts[r["bound"]] = counts.get(r["bound"], 0) + 1
        w("  bound mix: " + ", ".join(
            "%s x%d" % (b, counts[b]) for b in BOUNDS if b in counts))
    for p in res["problems"]:
        w("  PROBLEM: %s" % p)
    return res["problems"] if check else []
