"""Live observability plane: in-run HTTP scrape endpoints + watch tail.

The port's copy of the JAX package's ``obs/live.py`` (pure stdlib, no
torch import, no device access).  ``obs_http_port=0`` binds an ephemeral
port, read back from the socket (``RunObserver.live_url``), on
``obs_http_addr`` (127.0.0.1 by default).  ``obs watch --ranks`` tails
the per-rank shards of a distributed run (discovered by obs/merge.py),
aligning iterations across the ranks.

Every other obs surface is post-hoc — a JSONL timeline analyzed after
``run_end``.  This module is the in-situ half: a stdlib
``ThreadingHTTPServer`` daemon the observer starts when
``obs_http_port`` is set (port 0 = ephemeral, bound port reported via
``RunObserver.live_url``), serving four read-only endpoints:

* ``/metrics``  — Prometheus textfile exposition of the process-global
  registry (obs/metrics.py), the node-exporter scrape target;
* ``/healthz``  — 200 while the run is healthy, 503 the moment a fatal
  health verdict lands (obs/health.py) or the run aborts — the
  liveness/readiness probe;
* ``/statusz``  — one JSON snapshot: run_header provenance, lifecycle,
  current iteration + EWMA it/s, health verdicts, the latest schema-13
  ``utilization`` rollup, and the merged flight-provider context (the
  serve scheduler's queue depth and the SLO engine's headline ride in
  through the PR-7 registry) — the operator's "what is this run doing
  right now";
* ``/events?after=N`` — JSONL tail of the watchdog ring buffer with a
  monotonic cursor (``X-Obs-Next-After`` response header), the feed
  behind ``obs watch <url>``;
* ``/incidents`` — open/closed incident listing from the incident
  engine (obs/incident.py), including each incident's grouped signals
  and evidence inventory;
* ``/prof?seconds=N`` — on-demand host profile burst (obs/prof.py):
  a synchronous collapsed-stack capture of every thread except the
  handler's own, rendered as Brendan-Gregg folded text.  Loopback
  peers only (the same rule as the POST controls): a capture spends
  real sampling time on the host it profiles.

Schema 15 adds operator CONTROL alongside the reads: ``POST
/trigger/flight`` dumps a flight record on demand and ``POST
/trigger/incident`` opens (or joins) an incident with an ``operator``
signal — on-demand evidence capture while the anomaly is still live.
Both are accepted **only from a loopback peer address**, whatever the
bind address: scraping may be fleet-wide, capture control is local by
construction.

The server thread only READS host-side state the observer already
maintains — no jax import anywhere in this module, no device access, no
fence: scraping a live run costs the hot path nothing (the module is
inside the graftlint hostsync scope to keep it that way).  The POST
handlers write evidence from the handler thread, never touching the
hot path.  Binding defaults to loopback
(``obs_http_addr=127.0.0.1``); exposing the plane on a pod means
choosing a routable bind address deliberately.

The second half is ``watch`` — the ``python -m lightgbm_tpu_torch obs watch``
live-follow renderer.  It tails a growing timeline file (parsing only
complete lines, so a torn write never kills the tail), a per-rank shard
set (``--ranks``, shards discovered via obs/merge.py and iterations
aligned across ranks as they complete), or a live ``/events`` URL, and
renders iteration progress with an it/s sparkline, compile / health /
shed events and SLO verdicts as they happen.  ``--once`` renders what
is currently visible and exits — the CI-friendly snapshot mode.
"""
from __future__ import annotations

import collections
import http.server
import json
import socketserver
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

from .metrics import PROMETHEUS_CONTENT_TYPE, REGISTRY
from ..utils.log import Log

__all__ = ["LiveServer", "status_snapshot", "health_verdict", "watch"]


# ======================================================================
# writer side: the in-process scrape server
# ======================================================================

def health_verdict(obs):
    """("ok"|"warn"|"fatal", detail dict) from the observer's host-side
    health state.  Fatal means /healthz serves 503: a recorded fatal
    health event, a fatal monitor verdict, or an aborted close."""
    detail = {}
    status = "ok"
    health = getattr(obs, "health", None)
    if health is not None:
        status = health.verdict()
        detail["counts"] = dict(health.counts)
    if getattr(obs, "_health_fatal", False):
        status = "fatal"
    if getattr(obs, "_lifecycle", "") == "aborted":
        status = "fatal"
        detail["aborted"] = True
    return status, detail


def status_snapshot(obs):
    """The /statusz payload: one JSON-safe dict assembled purely from
    host-side observer state (header, EWMA iteration clock, health,
    latest utilization rollup, flight-provider context)."""
    out = {
        "run": getattr(obs, "run_id", None),
        "rank": getattr(obs, "rank", 0),
        "world_size": getattr(obs, "world_size", 1),
        "lifecycle": getattr(obs, "_lifecycle", "unknown"),
        "iters": getattr(obs, "_iters", 0),
        "events_path": getattr(obs, "events_path", ""),
        "t": time.time(),
    }
    header = getattr(obs, "_header", None)
    if header:
        out["backend"] = header.get("backend")
        out["schema"] = header.get("schema")
        out["devices"] = len(header.get("devices") or ())
        out["timing"] = header.get("timing")
        if header.get("provenance"):
            out["provenance"] = header["provenance"]
    last_it = getattr(obs, "_last_it", None)
    if last_it is not None:
        out["last_it"] = last_it
    ewma = getattr(obs, "_ewma_iter_s", None)
    if ewma:
        out["ewma_iter_s"] = round(float(ewma), 6)
        out["iters_per_sec"] = round(1.0 / float(ewma), 3)
    verdict, detail = health_verdict(obs)
    out["health"] = {"status": verdict}
    out["health"].update(detail)
    util = getattr(obs, "_last_utilization", None)
    if util:
        out["utilization"] = {
            k: util.get(k)
            for k in ("it", "flop_util", "hbm_util", "bound",
                      "headroom_s", "device_kind")
            if util.get(k) is not None}
    ctx_stamp = getattr(obs, "_run_context", None)
    if ctx_stamp:
        # the training loop's stamp_context: iteration, tree count,
        # loop stage — what the run was doing at this instant
        out["context"] = dict(ctx_stamp)
    try:
        ctx = obs.flight_context()
    except Exception:
        ctx = {}
    if ctx:
        # serve queue depth, SLO headline and the incident engine's
        # open/opened counters land here via the flight-provider
        # registry (serve/scheduler.py, obs/incident.py)
        out["flight"] = ctx
    ring = getattr(obs, "_ring", None)
    if ring is not None:
        out["ring"] = {"seq": ring.last_seq, "len": len(ring),
                       "dropped": ring.dropped,
                       "capacity": ring.capacity}
    return out


class _LiveHTTPServer(socketserver.ThreadingMixIn, http.server.HTTPServer):
    """ThreadingHTTPServer with daemon handler threads: a scrape in
    flight never blocks interpreter shutdown."""

    daemon_threads = True
    allow_reuse_address = True
    observer = None                    # set by LiveServer before serving


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "lgbm-obs-live"
    protocol_version = "HTTP/1.1"

    # the stdlib default logs one stderr line per request — a scraped
    # training run would drown its own logs
    def log_message(self, fmt, *args):
        pass

    def _send(self, code, ctype, body, headers=()):
        data = body.encode("utf-8") if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Cache-Control", "no-store")
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _send_json(self, code, payload, headers=()):
        self._send(code, "application/json",
                   json.dumps(payload, default=str) + "\n", headers)

    def do_GET(self):
        obs = self.server.observer
        try:
            parsed = urllib.parse.urlsplit(self.path)
            route = parsed.path.rstrip("/") or "/"
            if route == "/metrics":
                self._send(200, PROMETHEUS_CONTENT_TYPE,
                           REGISTRY.to_prometheus())
            elif route == "/healthz":
                verdict, detail = health_verdict(obs)
                payload = {"status": verdict}
                payload.update(detail)
                self._send_json(200 if verdict != "fatal" else 503,
                                payload)
            elif route == "/statusz":
                self._send_json(200, status_snapshot(obs))
            elif route == "/events":
                q = urllib.parse.parse_qs(parsed.query)
                try:
                    after = int(q.get("after", ["0"])[0])
                except ValueError:
                    after = 0
                seq, recs = obs.ring_tail(after)
                body = "".join(json.dumps(r, default=str) + "\n"
                               for r in recs)
                self._send(200, "application/x-ndjson", body,
                           headers=(("X-Obs-Next-After", str(seq)),))
            elif route == "/incidents":
                self._send_json(200, obs.incidents())
            elif route == "/prof":
                # on-demand host profile burst (obs/prof.py).  Loopback
                # peers only, like the POST controls: the capture spends
                # real sampling time on the host it profiles
                if not self._loopback_peer():
                    self._send_json(403, {"error": "/prof accepts "
                                                   "loopback peers only"})
                else:
                    q = urllib.parse.parse_qs(parsed.query)
                    try:
                        seconds = float(q.get("seconds", ["0.25"])[0])
                    except ValueError:
                        seconds = 0.25
                    seconds = max(0.05, min(5.0, seconds))
                    from .prof import burst, folded_text
                    payload = burst(
                        seconds=seconds,
                        context=getattr(obs, "_run_context", None),
                        source="live")
                    self._send(200, "text/plain; charset=utf-8",
                               folded_text(payload))
            elif route == "/":
                self._send_json(200, {"endpoints": ["/metrics", "/healthz",
                                                    "/statusz", "/events",
                                                    "/incidents",
                                                    "/prof?seconds=N",
                                                    "POST /trigger/flight",
                                                    "POST /trigger/incident"],
                                      "run": getattr(obs, "run_id", None)})
            else:
                self._send_json(404, {"error": "unknown path %s"
                                      % parsed.path})
        except Exception as e:      # a broken scrape must not kill serving
            try:
                self._send_json(500, {"error": repr(e)})
            except Exception:
                pass

    def _loopback_peer(self):
        peer = self.client_address[0] if self.client_address else ""
        return peer in ("127.0.0.1", "::1", "::ffff:127.0.0.1")

    def do_POST(self):
        """Operator control: on-demand flight dump and incident open.
        Loopback peers only — a routable bind address exposes the READ
        plane fleet-wide, never capture control."""
        obs = self.server.observer
        try:
            # drain the body first (HTTP/1.1 keep-alive contract),
            # whatever the verdict
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                length = 0
            raw = self.rfile.read(length) if length > 0 else b""
            if not self._loopback_peer():
                self._send_json(403, {"error": "control endpoints accept "
                                               "loopback POSTs only"})
                return
            try:
                body = json.loads(raw.decode("utf-8", "replace")) or {}
            except ValueError:
                body = {}
            if not isinstance(body, dict):
                body = {}
            reason = str(body.get("reason") or "operator request")[:200]
            route = urllib.parse.urlsplit(self.path).path.rstrip("/")
            if route == "/trigger/flight":
                path = obs.flight("operator: %s" % reason)
                self._send_json(200, {"triggered": "flight",
                                      "path": path or None})
            elif route == "/trigger/incident":
                iid = obs.incident_signal("operator", {"reason": reason})
                if iid is None:
                    self._send_json(409, {"error": "incident engine off "
                                                   "(obs_incident=false)"})
                else:
                    self._send_json(200, {"triggered": "incident",
                                          "id": iid})
            else:
                self._send_json(404, {"error": "unknown control path %s"
                                      % self.path})
        except Exception as e:      # a broken control call must not kill
            try:                    # the run it observes
                self._send_json(500, {"error": repr(e)})
            except Exception:
                pass


class LiveServer:
    """Lifecycle wrapper: bind, serve from a daemon thread, report the
    actual port (``port=0`` binds ephemeral), shut down cleanly."""

    def __init__(self, observer, port, addr="127.0.0.1"):
        self._observer = observer
        self._req_port = int(port)
        self.addr = str(addr or "127.0.0.1")
        self.port = None
        self.url = ""
        self._server = None
        self._thread = None

    def start(self):
        """Bind + serve; returns the URL.  Best-effort by contract: a
        bind failure logs and leaves the plane off rather than killing
        the training run it observes."""
        if self._server is not None:
            return self.url
        try:
            srv = _LiveHTTPServer((self.addr, self._req_port), _Handler)
        except OSError as e:
            Log.warning("obs: live server bind %s:%d failed: %s",
                        self.addr, self._req_port, e)
            return ""
        srv.observer = self._observer
        self._server = srv
        self.port = int(srv.server_address[1])
        self.url = "http://%s:%d" % (self.addr, self.port)
        self._thread = threading.Thread(
            target=srv.serve_forever, kwargs={"poll_interval": 0.1},
            name="lgbm-obs-live", daemon=True)
        self._thread.start()
        Log.debug("obs: live telemetry plane at %s "
                  "(/metrics /healthz /statusz /events)", self.url)
        return self.url

    def stop(self):
        srv, self._server = self._server, None
        if srv is None:
            return
        try:
            srv.shutdown()
            srv.server_close()
        except Exception:
            pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


# ======================================================================
# reader side: `obs watch` — live-follow a timeline, shard set, or URL
# ======================================================================

_SPARK = "▁▂▃▄▅▆▇█"


def _sparkline(values, width=16):
    vals = list(values)[-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(_SPARK[int((v - lo) / span * (len(_SPARK) - 1))]
                   for v in vals)


class _FileTail:
    """Incremental JSONL reader over a growing file: parses only
    complete lines, buffering a partial trailing line until the writer
    finishes it — a torn write mid-flush never kills the tail."""

    def __init__(self, path):
        self.path = str(path)
        self._pos = 0
        self._buf = ""

    def poll(self):
        try:
            with open(self.path) as f:
                f.seek(self._pos)
                chunk = f.read()
                self._pos = f.tell()
        except OSError:
            return []
        if not chunk:
            return []
        lines = (self._buf + chunk).split("\n")
        self._buf = lines.pop()
        out = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                pass                 # torn write: best-effort tail
        return out


class _UrlTail:
    """Cursor-based poller over a live /events endpoint."""

    def __init__(self, url, timeout_s=5.0):
        base = str(url).rstrip("/")
        if base.endswith("/events"):
            base = base[:-len("/events")]
        self.base = base
        self.after = 0
        self.timeout_s = float(timeout_s)

    def poll(self):
        req = "%s/events?after=%d" % (self.base, self.after)
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            nxt = r.headers.get("X-Obs-Next-After")
            body = r.read().decode("utf-8", "replace")
        if nxt is not None:
            try:
                self.after = int(nxt)
            except ValueError:
                pass
        out = []
        for line in body.splitlines():
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass
        return out

    def status(self):
        with urllib.request.urlopen(self.base + "/statusz",
                                    timeout=self.timeout_s) as r:
            return json.loads(r.read().decode("utf-8", "replace"))


class WatchRenderer:
    """Fold a stream of timeline events into operator-readable lines:
    iteration progress with an it/s sparkline, compile / health / shed
    events, SLO verdicts, and the run_end footer that ends a follow."""

    def __init__(self, out=None, show_rank=False):
        self.out = out or sys.stdout
        self.show_rank = bool(show_rank)
        self.done = False
        self.status = None
        self.iters = 0
        self._times = collections.deque(maxlen=64)

    def _w(self, s):
        self.out.write(s + "\n")
        try:
            self.out.flush()
        except Exception:
            pass

    def _tag(self, rank):
        return ("[r%s] " % rank) if (self.show_rank and rank is not None) \
            else ""

    def feed(self, rec, rank=None):
        ev = rec.get("ev")
        tag = self._tag(rank if rank is not None else rec.get("rank"))
        if ev == "run_header":
            prov = rec.get("provenance") or {}
            bits = ["run %s" % rec.get("run"),
                    "schema %s" % rec.get("schema"),
                    "backend %s" % rec.get("backend"),
                    "devices %d" % len(rec.get("devices") or ())]
            if int(rec.get("world_size", 1) or 1) > 1:
                bits.append("rank %s/%s" % (rec.get("rank"),
                                            rec.get("world_size")))
            if prov.get("git_rev"):
                bits.append("rev %s%s" % (prov["git_rev"],
                                          "+" if prov.get("git_dirty")
                                          else ""))
            self._w(tag + "▶ " + "  ".join(bits))
        elif ev == "iter":
            self.iters += 1
            dt = float(rec.get("time_s", 0.0))
            self._times.append(dt)
            window = list(self._times)[-8:]
            mean = sum(window) / len(window)
            ips = (1.0 / mean) if mean > 0 else 0.0
            self._w("%sit %-5s %8.4fs  %7.2f it/s  %s"
                    % (tag, rec.get("it"), dt, ips,
                       _sparkline(self._times)))
        elif ev == "compile":
            self._w("%scompile %s: first call %.3fs"
                    % (tag, rec.get("entry"),
                       float(rec.get("first_call_s", 0.0))))
        elif ev == "compile_attr" and int(rec.get("n_compiles", 1)) > 1:
            self._w("%sRECOMPILE %s: %s compiles"
                    % (tag, rec.get("entry"), rec.get("n_compiles")))
        elif ev == "health" and rec.get("check") != "stats":
            self._w("%shealth[%s] %s at it %s: %s"
                    % (tag, rec.get("status"), rec.get("check"),
                       rec.get("it"), rec.get("detail", "")))
        elif ev == "utilization":
            self._w("%sutil it %s: flop %.1f%%  hbm %.1f%%  %s"
                    % (tag, rec.get("it"),
                       100.0 * float(rec.get("flop_util", 0.0)),
                       100.0 * float(rec.get("hbm_util", 0.0)),
                       rec.get("bound", "?")))
        elif ev == "serve_slo":
            overall = rec.get("overall") or {}
            verdicts = rec.get("verdicts") or {}
            bits = ["qps %s" % overall.get("qps", "-")]
            if overall.get("p99_s") is not None:
                bits.append("p99 %.2fms" % (1e3 * overall["p99_s"]))
            for name, v in sorted(verdicts.items()):
                bits.append("%s=%s" % (name, v.upper()))
            if rec.get("alert") == "firing":
                bits.append("ALERT FIRING")
            self._w(tag + "slo: " + "  ".join(bits))
        elif ev == "drift":
            feats = rec.get("features") or []
            top = feats[0] if feats else None
            bits = ["psi_max %.3f" % float(rec.get("psi_max", 0.0))]
            if top:
                bits.append("top %s (psi %.3f)"
                            % (top.get("feature"),
                               float(top.get("psi", 0.0))))
            if rec.get("score_psi") is not None:
                bits.append("score %.3f" % float(rec["score_psi"]))
            bits.append("rows %s" % rec.get("rows"))
            # the WARN styling of the health lines: alerting windows
            # shout, stable ones stay lowercase
            head = ("DRIFT[warn] " if rec.get("alert") == "firing"
                    else "drift: ")
            self._w(tag + head + "  ".join(bits))
        elif ev == "online_quality":
            bits = ["n %s" % rec.get("n")]
            if rec.get("auc") is not None:
                bits.append("auc %.4f" % float(rec["auc"]))
                if rec.get("ref_auc") is not None:
                    bits.append("(train %.4f)" % float(rec["ref_auc"]))
            if rec.get("logloss") is not None:
                bits.append("logloss %.4f" % float(rec["logloss"]))
            self._w(tag + "online: " + "  ".join(bits))
        elif ev == "incident_open":
            sigs = ", ".join(str(s) for s in rec.get("signals") or ())
            self._w("%sINCIDENT OPEN [%s] trigger %s%s"
                    % (tag, rec.get("id"), rec.get("trigger"),
                       ("  -> %s" % rec["dir"]) if rec.get("dir") else ""))
            if sigs:
                self._w("%s  signals: %s" % (tag, sigs))
        elif ev == "incident_close":
            sigs = list(rec.get("signals") or ())
            counts = rec.get("counts") or {}
            total = sum(int(v or 0) for v in counts.values()) or len(sigs)
            self._w("%sINCIDENT CLOSE [%s] %d signal kind(s), %d event(s)"
                    " over %.1fs: %s"
                    % (tag, rec.get("id"), len(sigs), total,
                       float(rec.get("duration_s", 0.0) or 0.0),
                       ", ".join(str(s) for s in sigs)))
        elif ev == "serve_summary":
            shed = int(rec.get("shed_total", 0))
            self._w("%sserve: %s batches  %s rows  shed %d%s"
                    % (tag, rec.get("batches"), rec.get("rows"), shed,
                       "  ⚠" if shed else ""))
        elif ev == "mesh_shrink":
            self._w("%smesh shrink %s -> %s ranks at it %s"
                    % (tag, rec.get("world_size_from"),
                       rec.get("world_size_to"), rec.get("it")))
        elif ev == "run_end":
            self.done = True
            self.status = str(rec.get("status", "ok"))
            self._w("%s■ run end: status=%s  iters=%s"
                    % (tag, self.status, rec.get("iters")))

    def align(self, it, times):
        """One completed cross-rank iteration (--ranks): per-rank fenced
        times + skew, the live slice of the obs/merge.py view."""
        slowest = max(times, key=times.get)
        fastest = min(times, key=times.get)
        skew = times[slowest] - times[fastest]
        rel = skew / times[slowest] if times[slowest] > 0 else 0.0
        self.iters += 1
        self._times.append(times[slowest])
        self._w("it %-5s %s  skew %.1f%% (slowest r%s)  %s"
                % (it,
                   "  ".join("r%s %.4fs" % (r, times[r])
                             for r in sorted(times)),
                   100.0 * rel, slowest, _sparkline(self._times)))

    def render_status(self, status):
        """Footer from a /statusz snapshot (URL mode)."""
        bits = ["lifecycle %s" % status.get("lifecycle"),
                "iters %s" % status.get("iters")]
        if status.get("iters_per_sec") is not None:
            bits.append("%.2f it/s" % status["iters_per_sec"])
        h = status.get("health") or {}
        bits.append("health %s" % h.get("status", "?"))
        util = status.get("utilization")
        if util:
            bits.append("util flop %.1f%% hbm %.1f%% (%s)"
                        % (100.0 * float(util.get("flop_util", 0.0)),
                           100.0 * float(util.get("hbm_util", 0.0)),
                           util.get("bound", "?")))
        serve = (status.get("flight") or {}).get("serve")
        if serve:
            bits.append("queue %s" % serve.get("queue_depth"))
        slo = (status.get("flight") or {}).get("slo")
        if slo:
            overall = slo.get("overall") or {}
            if overall.get("p99_s") is not None:
                bits.append("p99 %.2fms" % (1e3 * overall["p99_s"]))
            if slo.get("alerting"):
                bits.append("SLO ALERT")
        drift = (status.get("flight") or {}).get("drift")
        if drift:
            last = drift.get("last") or {}
            if last.get("psi_max") is not None:
                bits.append("drift psi %.3f" % float(last["psi_max"]))
            if drift.get("alerting"):
                bits.append("DRIFT ALERT")
        inc = (status.get("flight") or {}).get("incidents")
        if inc:
            if inc.get("open"):
                last = inc.get("last") or {}
                bits.append("INCIDENT OPEN (%s)"
                            % (last.get("trigger") or "?"))
            elif inc.get("opened"):
                bits.append("incidents %s" % inc.get("opened"))
        self._w("status: " + "  ".join(bits))


def watch(target, once=False, ranks=False, interval_s=0.5, out=None,
          max_wall_s=0.0):
    """The ``obs watch`` implementation; returns a process exit code.

    ``target`` is a timeline file, a shard base (``--ranks`` tails every
    ``.rN`` sibling, aligning iterations across ranks), or an
    ``http://`` URL of a live plane (its ``/events`` feed).  ``--once``
    renders everything currently visible and exits 0; follow mode runs
    until the tailed run ends (exit 0), the server goes away (exit 0),
    or Ctrl-C.  ``max_wall_s`` is a follow-mode safety stop for
    scripted callers (0 = no limit)."""
    out = out or sys.stdout
    target = str(target)
    is_url = target.startswith(("http://", "https://"))
    renderer = WatchRenderer(out=out, show_rank=ranks)

    if is_url:
        tail = _UrlTail(target)
        tails = [(None, tail)]
    elif ranks:
        from .merge import _shard_rank_of, discover_shards
        try:
            paths = discover_shards(target)
        except OSError as e:
            print("error: %s" % e, file=sys.stderr)
            return 2
        tails = [(_shard_rank_of(p), _FileTail(p)) for p in paths]
        print("watching %d shard(s): %s" % (len(paths),
                                            "  ".join(paths)), file=out)
    else:
        tails = [(None, _FileTail(target))]

    # cross-rank iteration alignment (--ranks): print one line per
    # iteration once every tailed rank has reported it
    by_it = {}
    n_ranks = len(tails)

    def _drain():
        got = 0
        for rank, tail in tails:
            for rec in tail.poll():
                got += 1
                if ranks and rec.get("ev") == "iter":
                    r = rec.get("rank", rank)
                    times = by_it.setdefault(int(rec["it"]), {})
                    times[r] = float(rec.get("time_s", 0.0))
                    if len(times) == n_ranks:
                        renderer.align(rec["it"], by_it.pop(rec["it"]))
                    continue
                renderer.feed(rec, rank=rank)
        return got

    t0 = time.monotonic()
    try:
        total = _drain()
        if once:
            if is_url:
                try:
                    renderer.render_status(tails[0][1].status())
                except Exception as e:
                    print("statusz unavailable: %s" % e, file=sys.stderr)
            if total == 0 and renderer.iters == 0:
                print("no events yet (%s)" % target, file=out)
            return 0
        while not renderer.done:
            if max_wall_s and time.monotonic() - t0 > max_wall_s:
                print("watch: wall limit %.1fs reached" % max_wall_s,
                      file=out)
                return 0
            time.sleep(max(0.05, float(interval_s)))
            try:
                _drain()
            except (OSError, urllib.error.URLError):
                # the live server tore down at run_end before we saw it
                print("watch: source went away (run ended?)", file=out)
                return 0
    except KeyboardInterrupt:
        return 0
    return 0
