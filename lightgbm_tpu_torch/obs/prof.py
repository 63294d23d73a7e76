"""Continuous host sampling profiler (schema 16, ``prof_profile``).

The port's copy of the JAX package's ``obs/prof.py`` (pure stdlib: the
sampling thread walks Python frames and never calls into CUDA).  Frames
of the port keep their ``lightgbm_tpu_torch/...`` suffix.

``host_orchestration_s`` (schema 11) says HOW MUCH host time each
iteration spends between device program submissions; this module says
WHERE.  A daemon thread walks ``sys._current_frames()`` on a jittered
monotonic clock (``obs_prof_hz``, default ~29 Hz — a prime-ish rate so
the sampler cannot alias against a periodic training cadence; ``0``
disables), folds every thread's stack into Brendan-Gregg collapsed-stack
counts, and tags each sample with the live context the observer already
maintains: the stamped loop stage (``stamp_context`` — boost / eval /
checkpoint), the phase-timer lap most recently crossed, the current
iteration, and the thread's role (its name — every in-tree daemon
thread carries a stable ``lgbm-<role>`` name exactly so these profiles
attribute by role instead of ``Thread-7``).

Samples aggregate into one ``prof_profile`` event per
``obs_prof_window_s`` window: the top-K folded stacks plus a
truncated-tail count, per-role / per-stage / per-phase sample totals,
the iteration span the window covered, and — first class, because an
always-on profiler that silently eats the run is worse than none — the
sampler's **self-measured cost** (``cost_s`` / ``overhead_frac``).
``bench.py --dry`` asserts ``overhead_frac < 1%``, the ledger records
it as a gated cell, and ``obs prof --check`` exits 1 when any window
blew the budget, carries a sampler ``error``, or saw zero samples while
iterations advanced (a wedged sampler must be loud, not silent).

Consumers:

* ``python -m lightgbm_tpu_torch obs prof <timeline|dir> [--check]
  [--flame out.html] [--top N]`` — terminal top-table +
  self-contained (d3-free) HTML flamegraph;
* ``GET /prof?seconds=N`` on the live plane (obs/live.py) — on-demand
  synchronous burst capture, loopback peers only;
* incident evidence bundles (obs/incident.py) — a sampled profile
  window lands next to the one-shot thread stacks;
* ``tools/tpu_profile.py`` — the host top-table printed next to the
  device trace, so one command shows both halves of the pipeline.

Everything here is pure stdlib and host-side: no torch import, no
fence — sampling must never perturb the async dispatch pipeline it
measures.  ``capture_thread_stacks`` is the one shared stack-capture
path: the watchdog's flight records and incident evidence delegate
here, so there is exactly one ``sys._current_frames`` walker in tree.
"""
from __future__ import annotations

import html as _html
import json
import os
import random
import sys
import threading
import time
import traceback

from ..utils.log import Log

# the gated overhead budget: self-measured sampling cost per window as a
# fraction of the window's wall time.  bench.py --dry and `obs prof
# --check` both gate on this constant.
OVERHEAD_BUDGET_FRAC = 0.01

_PKG_MARKER = os.sep + "lightgbm_tpu_torch" + os.sep


# ---------------------------------------------------------------- folding

def _short_path(path):
    """Shorten a code filename for stack labels: files under the package
    root keep their ``lightgbm_tpu/...`` suffix (so "top stack lands in
    lightgbm_tpu code" is a substring check), everything else collapses
    to ``parent/file.py``."""
    i = path.rfind(_PKG_MARKER)
    if i >= 0:
        return "lightgbm_tpu_torch/" + path[i + len(_PKG_MARKER):].replace(
            os.sep, "/")
    base = os.path.basename(path)
    parent = os.path.basename(os.path.dirname(path))
    return (parent + "/" + base) if parent else base


# code objects are immutable and long-lived, so the label each one
# folds to is computed once -- the memo keeps every sampling tick to a
# dict hit per frame instead of two basename walks and a format.  It is
# keyed by id(code): hashing a code object hashes its constants and
# names each time (~2 us a frame, which put a deep stack's tick at
# several times its budget), while an int key hashes at once; each
# entry keeps its code object, so the id stays that object's while it
# is in the memo, and the identity check makes the key exact
_LABEL_MEMO = {}


def _frame_label(code):
    entry = _LABEL_MEMO.get(id(code))
    if entry is None or entry[0] is not code:
        entry = (code, "%s:%s" % (_short_path(code.co_filename),
                                  code.co_name))
        _LABEL_MEMO[id(code)] = entry
    return entry[1]


def fold_frames(frame):
    """Root->leaf ``shortpath:func`` labels for one thread's live stack
    (the Brendan-Gregg collapsed-stack frame list, minus line numbers —
    line-level splits would shred the counts across samples)."""
    labels = []
    while frame is not None:
        labels.append(_frame_label(frame.f_code))
        frame = frame.f_back
    labels.reverse()
    return labels


def thread_roles():
    """{ident: thread name} for every live thread — the role map both
    the sampler and the flight-record capture attribute by."""
    return {t.ident: t.name for t in threading.enumerate()}


# leaves a thread parks in while doing nothing: selector/socket waits,
# lock/event waits, queue gets.  A stack whose leaf is one of these AND
# that never passes through lightgbm_tpu code is an idle stdlib thread
# (an http server's select loop, a parked pool worker) — pure wait, not
# cost, so the sampler skips it (py-spy's default --idle=false).  In-tree
# threads are always kept, whatever their leaf: a blocked EventWriter or
# serve worker passes through lightgbm_tpu frames, and seeing WHERE it
# waits is the point.
_IDLE_LEAF_NAMES = frozenset((
    "select", "poll", "epoll", "kqueue", "wait", "_wait_for_tstate_lock",
    "accept", "acquire", "get", "sleep", "_recv", "recv", "read",
    "readinto"))


def _is_idle_stack(labels):
    if not labels:
        return True
    if any(lb.startswith("lightgbm_tpu_torch/") for lb in labels):
        return False
    return labels[-1].rsplit(":", 1)[-1] in _IDLE_LEAF_NAMES


def capture_thread_stacks():
    """One-shot ``{"name (ident)": [formatted frame lines]}`` for every
    live Python thread — the flight-record / incident-evidence shape
    (obs/watchdog.py delegates here; keep the shape stable)."""
    names = thread_roles()
    out = {}
    for ident, frame in sys._current_frames().items():
        label = "%s (%d)" % (names.get(ident, "?"), ident)
        out[label] = [ln.rstrip("\n")
                      for ln in traceback.format_stack(frame)]
    return out


# ------------------------------------------------------------- the window

class _Window:
    """One aggregation window of samples.  ``samples`` counts sampler
    ticks (each tick walks every thread, so per-role totals can exceed
    it); ``cost_s`` is the sampler's own accumulated per-tick cost."""

    __slots__ = ("t0", "samples", "cost_s", "stacks", "roles", "stages",
                 "phases", "iter_lo", "iter_hi", "error")

    def __init__(self, t0):
        self.t0 = t0
        self.samples = 0
        self.cost_s = 0.0
        self.stacks = {}          # "role;frame;frame;..." -> tick count
        self.roles = {}
        self.stages = {}
        self.phases = {}
        self.iter_lo = None
        self.iter_hi = None
        self.error = ""


def aggregate_window(window, dur_s, hz, topk):
    """Reduce a ``_Window`` to the ``prof_profile`` event payload:
    top-K stacks (deterministic count-then-name order), truncated-tail
    count, per-dimension totals, and the self-measured overhead.
    ``topk <= 0`` keeps every stack (burst captures)."""
    ranked = sorted(window.stacks.items(), key=lambda kv: (-kv[1], kv[0]))
    keep = ranked if topk <= 0 else ranked[:topk]
    truncated = sum(c for _, c in ranked[len(keep):])
    dur_s = max(float(dur_s), 1e-9)
    payload = {
        "samples": window.samples,
        "dur_s": round(dur_s, 6),
        "hz": hz,
        "cost_s": round(window.cost_s, 6),
        "overhead_frac": round(window.cost_s / dur_s, 6),
        "stacks": dict(keep),
        "truncated": truncated,
        "topk": max(0, topk),
        "roles": dict(window.roles),
        "stages": dict(window.stages),
        "phases": dict(window.phases),
    }
    if window.iter_lo is not None:
        payload["iter_lo"] = window.iter_lo
        payload["iter_hi"] = window.iter_hi
    if window.error:
        payload["error"] = window.error
    return payload


# ------------------------------------------------------------ the sampler

class HostProfiler:
    """The always-on sampling profiler behind ``obs_prof_hz``.

    ``emit(ev, **fields)`` receives one ``prof_profile`` payload per
    flushed window (RunObserver passes its ``event`` method).  The
    clock and the frame source are injectable so the window/fold/
    truncation logic unit-tests against a fake clock, and a test can
    wedge the sampler on purpose (``frames_fn`` that raises) to prove
    the failure is loud: the loop catches the exception, stamps it as
    the window's ``error``, flushes that window, and stops — one
    poisoned window on the timeline instead of a silent gap.

    ``context`` is the observer's live ``_run_context`` dict (read
    racily, never locked — a torn read tags one sample with a stale
    stage, which the aggregate does not care about); ``phase_of`` /
    ``iter_of`` are zero-arg callables for the phase-timer lap and the
    current iteration.
    """

    def __init__(self, emit, hz=29, window_s=5.0, topk=20, context=None,
                 phase_of=None, iter_of=None, clock=time.monotonic,
                 frames_fn=None, source="train"):
        self._emit = emit
        self.hz = max(1, int(hz))
        self.window_s = float(window_s)
        self.topk = int(topk)
        self.source = str(source)
        self._context = context if context is not None else {}
        self._phase_of = phase_of
        self._iter_of = iter_of
        self._clock = clock
        self._frames = frames_fn or sys._current_frames
        self._lock = threading.Lock()
        self._window = _Window(clock())
        self._stop_evt = threading.Event()
        self._thread = None
        self.windows_emitted = 0
        self.wedged = False

    # ------------------------------------------------------------ lifecycle
    def start(self):
        """Start the daemon sampler thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_evt = threading.Event()
        self.wedged = False
        with self._lock:
            self._window = _Window(self._clock())
        self._thread = threading.Thread(target=self._loop,
                                        name="lgbm-obs-prof", daemon=True)
        self._thread.start()

    def stop(self):
        """Stop sampling and flush the final partial window (so a short
        run still lands >= 1 ``prof_profile`` on its timeline).
        Idempotent; a window that never saw a tick is dropped rather
        than emitted as a spurious zero-sample record."""
        thread, self._thread = self._thread, None
        if thread is None:
            return
        self._stop_evt.set()
        thread.join(timeout=2.0)
        with self._lock:
            has_content = self._window.samples > 0 or self._window.error
        if has_content:
            self.flush_now()

    @property
    def running(self):
        return self._thread is not None and self._thread.is_alive()

    # ------------------------------------------------------------- sampling
    def tick(self, exclude_ident=None):
        """One sampling tick: walk every thread's live frame, fold, tag
        with stage/phase/iteration, accumulate self-cost.  Public so
        fake-clock tests and burst captures drive it directly."""
        t0 = self._clock()
        if exclude_ident is None and self._thread is not None:
            exclude_ident = self._thread.ident
        frames = self._frames()
        names = thread_roles()
        try:
            stage = str(self._context.get("stage") or "-")
        except Exception:
            stage = "-"
        phase = "-"
        if self._phase_of is not None:
            try:
                phase = str(self._phase_of() or "-")
            except Exception:
                phase = "-"
        it = None
        if self._iter_of is not None:
            try:
                it = self._iter_of()
            except Exception:
                it = None
        with self._lock:
            w = self._window
            w.samples += 1
            for ident, frame in frames.items():
                if ident == exclude_ident:
                    continue
                labels = fold_frames(frame)
                if _is_idle_stack(labels):
                    continue
                role = names.get(ident, "thread-%d" % ident)
                key = ";".join([role] + labels)
                w.stacks[key] = w.stacks.get(key, 0) + 1
                w.roles[role] = w.roles.get(role, 0) + 1
            w.stages[stage] = w.stages.get(stage, 0) + 1
            w.phases[phase] = w.phases.get(phase, 0) + 1
            if it is not None:
                it = int(it)
                if w.iter_lo is None:
                    w.iter_lo = it
                w.iter_hi = (it if w.iter_hi is None
                             else max(it, w.iter_hi))
            w.cost_s += max(0.0, self._clock() - t0)

    def flush_now(self, now=None):
        """Swap the window out and emit it as a ``prof_profile`` event.
        Best-effort: a failed emit logs, never raises into the run."""
        now = self._clock() if now is None else now
        with self._lock:
            w, self._window = self._window, _Window(now)
        payload = aggregate_window(w, now - w.t0, self.hz, self.topk)
        payload["source"] = self.source
        try:
            self._emit("prof_profile", **payload)
            self.windows_emitted += 1
        except Exception as e:
            Log.warning("obs: prof window emit failed: %s", e)
        return payload

    def peek(self):
        """Aggregate of the current partial window WITHOUT flushing —
        the incident-evidence snapshot (best-effort, lock held only for
        the copy)."""
        with self._lock:
            w = self._window
            snap = _Window(w.t0)
            snap.samples = w.samples
            snap.cost_s = w.cost_s
            snap.stacks = dict(w.stacks)
            snap.roles = dict(w.roles)
            snap.stages = dict(w.stages)
            snap.phases = dict(w.phases)
            snap.iter_lo, snap.iter_hi = w.iter_lo, w.iter_hi
            snap.error = w.error
        payload = aggregate_window(snap, self._clock() - snap.t0,
                                   self.hz, self.topk)
        payload["source"] = self.source
        return payload

    # ---------------------------------------------------------------- loop
    def _loop(self):
        period = 1.0 / self.hz
        # deterministic jitter stream: +/-20% around the nominal period
        # so the sampler cannot phase-lock onto the iteration cadence
        rng = random.Random(0x5EED)
        while not self._stop_evt.is_set():
            self._stop_evt.wait(period * (0.8 + 0.4 * rng.random()))
            if self._stop_evt.is_set():
                return
            try:
                self.tick()
            except Exception as e:
                # the wedged-sampler contract: stamp the window, flush
                # it (so --check sees the error), stop sampling — loud
                # exactly once, never a silent gap
                with self._lock:
                    self._window.error = repr(e)
                self.wedged = True
                self.flush_now()
                Log.warning("obs: host profiler wedged, sampling "
                            "stopped: %s", e)
                return
            now = self._clock()
            with self._lock:
                due = now - self._window.t0 >= self.window_s
            if due:
                self.flush_now(now)


def burst(seconds=0.25, hz=97, topk=0, context=None, phase_of=None,
          iter_of=None, source="burst"):
    """Synchronous capture from the calling thread: sample every OTHER
    thread for ``seconds`` at ``hz`` and return the aggregated window
    payload (untruncated by default).  Pure host work, zero fences —
    the ``GET /prof`` endpoint, incident evidence and the bench
    fence-flatness assert all run through here."""
    payloads = []
    prof = HostProfiler(emit=lambda ev, **f: payloads.append(f),
                        hz=hz, window_s=float("inf"), topk=topk,
                        context=context, phase_of=phase_of,
                        iter_of=iter_of, source=source)
    me = threading.get_ident()
    period = 1.0 / float(hz)
    deadline = time.monotonic() + max(0.0, float(seconds))
    while True:
        prof.tick(exclude_ident=me)
        if time.monotonic() >= deadline:
            break
        time.sleep(period)
    prof.flush_now()
    return payloads[-1]


def evidence_profile(obs, seconds=0.15):
    """The incident-evidence payload: the live profiler's current
    partial window when one is armed (free — no extra sampling at the
    moment of anomaly), else a short synchronous burst."""
    prof = getattr(obs, "_prof", None)
    if prof is not None and prof.running:
        return prof.peek()
    return burst(seconds=seconds,
                 context=getattr(obs, "_run_context", None),
                 source="incident")


# ========================================================================
# reader side: `obs prof` — top table, flamegraph, the --check gate
# ========================================================================

def profile_events(events):
    return [e for e in events if e.get("ev") == "prof_profile"]


def merged_profile(profs):
    """Merge a run's windows into one rollup: summed stack counts,
    per-dimension totals, total samples/duration/cost."""
    out = {"windows": len(profs), "samples": 0, "dur_s": 0.0,
           "cost_s": 0.0, "truncated": 0, "stacks": {}, "roles": {},
           "stages": {}, "phases": {}, "errors": []}
    for p in profs:
        out["samples"] += int(p.get("samples", 0) or 0)
        out["dur_s"] += float(p.get("dur_s", 0.0) or 0.0)
        out["cost_s"] += float(p.get("cost_s", 0.0) or 0.0)
        out["truncated"] += int(p.get("truncated", 0) or 0)
        for field in ("stacks", "roles", "stages", "phases"):
            for k, v in (p.get(field) or {}).items():
                out[field][k] = out[field].get(k, 0) + int(v)
        if p.get("error"):
            out["errors"].append(str(p["error"]))
    out["overhead_frac"] = (out["cost_s"] / out["dur_s"]
                            if out["dur_s"] > 0 else 0.0)
    return out


def check_profiles(events, budget=OVERHEAD_BUDGET_FRAC):
    """The gate behind ``obs prof --check``: list of problem strings
    (empty = pass).  Fails on a sampler ``error`` window, a run whose
    total sampling overhead (summed cost over summed duration — the
    same number the ledger records) blows the budget, or a zero-sample
    window on a timeline whose iterations advanced (a wedged sampler
    next to a live training loop).  The budget gates the run, not each
    window: a short final flush amplifies per-window noise without
    costing the run anything.  A timeline with no ``prof_profile``
    events at all passes — the profiler may simply be off
    (``obs_prof_hz=0``)."""
    problems = []
    iters_advanced = sum(1 for e in events if e.get("ev") == "iter") >= 2
    profs = profile_events(events)
    for i, p in enumerate(profs):
        if p.get("error"):
            problems.append("window %d: sampler error: %s"
                            % (i, p["error"]))
        if int(p.get("samples", 0) or 0) == 0 and iters_advanced:
            problems.append(
                "window %d: zero samples while iterations advanced "
                "(wedged sampler)" % i)
    if profs:
        m = merged_profile(profs)
        if m["overhead_frac"] > budget:
            problems.append(
                "run: sampling overhead %.3f%% blows the %.1f%% budget"
                % (100.0 * m["overhead_frac"], 100.0 * budget))
    return problems


def _leaf(folded):
    return folded.rsplit(";", 1)[-1]


def render_top(events, top=20, out=None):
    """Terminal top-table over a run's merged windows: headline totals,
    per-role / per-stage / per-phase attribution, then the hottest
    folded stacks with their leaf frame.  Returns the merged rollup
    (None when the timeline has no profile windows)."""
    out = out or sys.stdout
    profs = profile_events(events)
    if not profs:
        print("no prof_profile events (profiler off? obs_prof_hz=0)",
              file=out)
        return None
    m = merged_profile(profs)
    print("host profile: %d window(s), %d sample(s) over %.1fs  "
          "overhead %.3f%% (budget %.1f%%)"
          % (m["windows"], m["samples"], m["dur_s"],
             100.0 * m["overhead_frac"], 100.0 * OVERHEAD_BUDGET_FRAC),
          file=out)
    for err in m["errors"]:
        print("  sampler error: %s" % err, file=out)
    for field, title in (("roles", "thread roles"),
                         ("stages", "loop stages"),
                         ("phases", "phases")):
        cells = sorted(m[field].items(), key=lambda kv: (-kv[1], kv[0]))
        if cells:
            print("  %s: %s" % (title,
                                "  ".join("%s=%d" % kv for kv in cells)),
                  file=out)
    ranked = sorted(m["stacks"].items(), key=lambda kv: (-kv[1], kv[0]))
    total = sum(m["stacks"].values()) or 1
    print("\n%7s %6s  %s" % ("samples", "pct", "hottest stacks "
                             "(role;root;...;leaf)"), file=out)
    for folded, count in ranked[:max(1, int(top))]:
        print("%7d %5.1f%%  %s" % (count, 100.0 * count / total,
                                   _leaf(folded)), file=out)
        print("%s%s" % (" " * 16, folded), file=out)
    shown = sum(c for _, c in ranked[:max(1, int(top))])
    tail = total - shown + m["truncated"]
    if tail > 0:
        print("%7d %5.1f%%  (truncated tail)" % (tail,
                                                 100.0 * tail / total),
              file=out)
    return m


# ------------------------------------------------------------- flamegraph

def _flame_tree(stacks):
    root = {"name": "all", "value": 0, "children": {}}
    for folded, count in stacks.items():
        count = int(count)
        root["value"] += count
        node = root
        for part in folded.split(";"):
            child = node["children"].setdefault(
                part, {"name": part, "value": 0, "children": {}})
            child["value"] += count
            node = child
    return root


def _flame_color(name):
    # deterministic warm hue per frame label (classic flamegraph look)
    h = 0
    for ch in name:
        h = (h * 131 + ord(ch)) & 0xFFFFFF
    return "hsl(%d,%d%%,%d%%)" % (20 + h % 40, 60 + (h >> 8) % 30,
                                  52 + (h >> 16) % 16)


def _flame_node_html(node, total, parts):
    share = 100.0 * node["value"] / max(total, 1)
    if share < 0.1:                     # sub-pixel slivers render as noise
        return
    label = _html.escape(node["name"])
    # the node fills the wrapper its parent sized for it; only the
    # wrapper (below) carries a proportional width
    parts.append(
        '<div class="node">'
        '<div class="lbl" style="background:%s" title="%s — %d samples '
        '(%.1f%%)">%s</div>' % (_flame_color(node["name"]), label,
                                node["value"], share, label))
    children = sorted(node["children"].values(),
                      key=lambda c: (-c["value"], c["name"]))
    if children:
        parts.append('<div class="row">')
        for child in children:
            # child width is relative to THIS node's box
            parts.append('<div style="width:%.4f%%">'
                         % (100.0 * child["value"]
                            / max(node["value"], 1)))
            _flame_node_html(child, total, parts)
            parts.append('</div>')
        parts.append('</div>')
    parts.append('</div>')


def render_flame(events, out_path):
    """Self-contained HTML flamegraph (no d3, no external JS — nested
    proportional-width divs with hover tooltips) over the merged
    windows.  Returns the total sample count rendered."""
    profs = profile_events(events)
    merged = merged_profile(profs) if profs else {"stacks": {},
                                                  "samples": 0,
                                                  "dur_s": 0.0,
                                                  "overhead_frac": 0.0,
                                                  "windows": 0}
    tree = _flame_tree(merged["stacks"])
    parts = []
    _flame_node_html(tree, tree["value"], parts)
    body = "".join(parts) or "<p>no samples</p>"
    doc = (
        "<!doctype html><html><head><meta charset=\"utf-8\">"
        "<title>lightgbm_tpu host flamegraph</title><style>"
        "body{font:12px monospace;margin:12px}"
        ".row{display:flex;width:100%%}"
        ".node{overflow:hidden}"
        ".lbl{border:1px solid #fff;border-radius:2px;padding:0 3px;"
        "white-space:nowrap;overflow:hidden;text-overflow:ellipsis;"
        "cursor:default;font-size:11px;line-height:15px}"
        "</style></head><body>"
        "<h3>host sampling profile — %d window(s), %d sample(s) over "
        "%.1fs, overhead %.3f%%</h3>"
        "<p>width &prop; samples; hover a frame for its count. "
        "Stacks grow downward (root at top).</p>%s</body></html>"
        % (merged.get("windows", 0), tree["value"],
           merged.get("dur_s", 0.0),
           100.0 * merged.get("overhead_frac", 0.0), body))
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(out_path, "w") as f:
        f.write(doc)
    return tree["value"]


def resolve_target(target):
    """``obs prof`` accepts a timeline file or a directory: a directory
    resolves to its newest ``*.jsonl`` (an incident bundle's ``ring``
    slice, a run directory, ...)."""
    if os.path.isdir(target):
        cands = [os.path.join(target, n) for n in os.listdir(target)
                 if n.endswith(".jsonl")]
        if not cands:
            raise ValueError("no .jsonl timeline in directory %s"
                             % target)
        return max(cands, key=lambda p: os.path.getmtime(p))
    return target


def render_prof_report(target, top=20, flame="", check=False, out=None):
    """The ``obs prof`` subcommand body: load the timeline (file or
    directory), print the top table, optionally write the flamegraph,
    and return the ``--check`` problem list."""
    from .query import last_run, load_timeline
    out = out or sys.stdout
    events = last_run(load_timeline(resolve_target(target)))
    render_top(events, top=top, out=out)
    if flame:
        n = render_flame(events, flame)
        print("\nwrote flamegraph (%d samples) -> %s" % (n, flame),
              file=out)
    problems = check_profiles(events)
    if problems:
        print("\nPROF CHECK: %d problem(s)" % len(problems), file=out)
        for p in problems:
            print("  - %s" % p, file=out)
    elif check:
        print("\nPROF CHECK: ok", file=out)
    return problems


def folded_text(payload):
    """One ``stack count`` line per folded stack (the py-spy /
    flamegraph.pl collapsed format) — the ``GET /prof`` body."""
    stacks = payload.get("stacks") or {}
    lines = ["%s %d" % (k, v) for k, v in
             sorted(stacks.items(), key=lambda kv: (-kv[1], kv[0]))]
    header = ("# samples=%d dur_s=%.3f overhead_frac=%.5f"
              % (payload.get("samples", 0), payload.get("dur_s", 0.0),
                 payload.get("overhead_frac", 0.0)))
    return "\n".join([header] + lines) + "\n"


if __name__ == "__main__":          # pragma: no cover - debugging aid
    print(json.dumps(burst(seconds=0.5), indent=2))
