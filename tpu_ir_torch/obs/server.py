"""The embedded HTTP server of a serving process (the port of
`tpu_ir/obs/server.py`).

One stdlib `ThreadingHTTPServer` (daemon request threads, port 0 picks a
free one) serves:

  POST /rpc/<name>   the instance's RPC handlers (`rpc_handlers`): a JSON
                     body in, the handler's JSON out. The caller's
                     `traceparent` is adopted around the handler, and the
                     answer carries this process's span records of that
                     trace under `_trace`. 503 with `reason` and `level`
                     when the handler sheds (Overloaded), 500 with the
                     repr of any other error, 404 for another route or an
                     unknown handler, 400 for a malformed body.
  GET  /healthz      liveness and the serving control plane: the newest
                     live frontend's breaker, ladder and queue depth, every
                     live frontend's stats, the ingest counters, the newest
                     live router's fleet view under `shards` (shard ->
                     replica liveness, breaker, worker identity and
                     generation, trailing latency), the newest live
                     autoscaler's section under `autoscaler` (epoch,
                     lifecycle, hysteresis, its last decision), and the
                     instance's `extra_health` (a worker's identity).
  GET  /metrics      the registry as Prometheus text (registry.py's
                     prometheus_text). Read-only: `?reset=1` is refused
                     with 403, so a scraper never drains the intervals the
                     process's own readers measure.
  GET  /metrics.json the registry's snapshot as JSON.
  GET  /profile      the device-cost profiler's report (obs/profiling.py:
                     cold calls by signature, the dispatch split, memory,
                     the recompile window, the kernel-build ledger);
                     `?format=html` a page of the same JSON.
  GET  /doctor       a health report (index/doctor.py) of each index dir
                     this process loaded (the last four Scorer.load
                     registered), cached until its metadata or serving
                     caches change; `?index=PATH` one registered dir (an
                     unregistered path is refused, never read);
                     `?format=html` a page.
  GET  /jobs         the job history (obs/progress.py), newest first;
                     `?format=html` one table a job, a row a phase.
  GET  /jobs/<id>    one job, JSON or `?format=html`; 404 for an unknown
                     id.
  GET  /querylog     the query log (obs/querylog.py): its settings and
                     counts, the ring's entries and the slow captures
                     (`?slow=1` the captures only, `?n=N` the newest N);
                     `?format=html` a page of the same JSON.
  GET  /flight       the newest flight records' headers, newest first.
  GET  /slo          the SLO burn-rate windows (disttrace.slo_snapshot);
                     `?format=html` a page of the same JSON.
  GET  /trace        the trace ids this process stores.
  GET  /trace/<id>   one trace stitched from the store and the spool;
                     `?format=html` its waterfall; 404 for an unknown id.
  GET  /timeseries   the telemetry time machine (obs/timeseries.py): the
                     tier layout, every curated series as [t, value]
                     points a tier, the recent anomalies and the newest
                     forecast fit; `?cluster=1` folds the spooled
                     processes' stores in (the same wall window's deltas
                     add); `?format=html` one sparkline a series a tier.
  GET  /cluster      the spool's cluster view (obs/aggregate.py's
                     merge_spool, this process counted once); 404 when
                     TPU_IR_TELEMETRY_DIR is not set; `?format=html` a
                     page of the same JSON.
  GET  /             the list of these endpoints.

Each running server holds one reference on the process's timeseries
sampler (the thread stops when the last server stops), and with
TPU_IR_TELEMETRY_DIR set runs a SpoolWriter (its snapshot and its store
spooled every TPU_IR_SPOOL_INTERVAL, the last on stop). The health keys
are `tpu_ir`'s; `recompiles_last_60s` counts the profiler's recompile
events (unwarmed coalesced dispatches) of the last minute.
"""

from __future__ import annotations

import html
import json
import logging
import os
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from . import disttrace, profiling, progress, querylog
from .recorder import recent_headers
from .registry import get_registry

logger = logging.getLogger(__name__)

_health_lock = threading.Lock()
_frontends: list = []  # weakrefs to live ServingFrontends, oldest first
_routers: list = []    # weakrefs to live routers (serving/router.py)
_autoscalers: list = []  # weakrefs to live Autoscalers (serving/autoscale.py)
_index_dirs: list = []  # index dirs this process loaded, oldest first
_MAX_INDEX_DIRS = 4
_doctor_cache: dict = {}  # dir -> (its stamp, its report)

_PROCESS_START = time.time()
_PROCESS_START_ISO = time.strftime("%Y-%m-%dT%H:%M:%S",
                                   time.localtime(_PROCESS_START))
_BUILD_SHA: list = []


def register_health_source(frontend) -> None:
    """Called by ServingFrontend.__init__: /healthz reports the state of
    every frontend still alive (weakrefs: the server never keeps a dead
    frontend's scorer on the card)."""
    with _health_lock:
        _frontends.append(weakref.ref(frontend))


def register_router(router) -> None:
    """Called by Router.__init__: /healthz aggregates the router's fleet
    (Router.health_summary). A weakref, as for the frontends: the server
    keeps no closed router alive."""
    with _health_lock:
        _routers.append(weakref.ref(router))


def register_autoscaler(autoscaler) -> None:
    """Called by Autoscaler.__init__: /healthz reports the newest live
    one's control loop (its epoch, each replica's lifecycle, the
    hysteresis counters, the last decision and its reason). A weakref,
    as for the routers."""
    with _health_lock:
        _autoscalers.append(weakref.ref(autoscaler))


def register_index_dir(path) -> None:
    """Called by Scorer.load: /doctor reports the index dirs this process
    serves (the last _MAX_INDEX_DIRS distinct ones), and never reads a
    path a caller names."""
    path = os.path.abspath(path)
    with _health_lock:
        if path in _index_dirs:
            _index_dirs.remove(path)
        _index_dirs.append(path)
        del _index_dirs[:-_MAX_INDEX_DIRS]
        for stale in [d for d in _doctor_cache if d not in _index_dirs]:
            del _doctor_cache[stale]


def registered_index_dirs() -> list:
    with _health_lock:
        return list(_index_dirs)


def _doctor_stamp(d: str) -> tuple:
    """What invalidates a cached report: metadata.json's mtime and those
    of the serving caches (`warm` writes one without touching the
    metadata)."""
    stamp = [os.stat(os.path.join(d, "metadata.json")).st_mtime_ns]
    try:
        for name in sorted(os.listdir(d)):
            if name.startswith("serving-"):
                stamp.append(
                    (name, os.stat(os.path.join(d, name)).st_mtime_ns))
    except OSError:
        pass
    return tuple(stamp)


def _doctor_payload(query: dict) -> dict:
    """/doctor's body: a report a registered dir, newest first, cached by
    _doctor_stamp; `?index=PATH` narrows to one registered dir."""
    from ..index.doctor import doctor_report

    dirs = list(reversed(registered_index_dirs()))
    want = query.get("index", [None])[0]
    if want is not None:
        want = os.path.abspath(want)
        if want not in dirs:
            return {"error": f"{want} is not a registered index dir",
                    "registered": dirs}
        dirs = [want]
    if not dirs:
        return {"error": "no index loaded in this process yet",
                "indexes": {}}
    out = {}
    for d in dirs:
        try:
            stamp = _doctor_stamp(d)
            with _health_lock:
                cached = _doctor_cache.get(d)
            if cached is not None and cached[0] == stamp:
                out[d] = cached[1]
                continue
            report = doctor_report(d)
            with _health_lock:
                _doctor_cache[d] = (stamp, report)
            out[d] = report
        except Exception as e:  # noqa: BLE001 — one sick index must not
            out[d] = {"error": repr(e)}  # hide the others' reports
    return {"indexes": out}


def _live(refs: list) -> list:
    """The objects of `refs` still alive, oldest first; the dead refs
    are dropped."""
    with _health_lock:
        alive = [(r, r()) for r in refs]
        refs[:] = [r for r, f in alive if f is not None]
        return [f for _, f in alive if f is not None]


def _build_sha() -> str | None:
    """The checkout's short commit, asked once (None outside a git
    checkout)."""
    if not _BUILD_SHA:
        try:
            import subprocess

            sha = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=10).stdout.strip()
        except Exception:  # noqa: BLE001 — health must not 500
            sha = ""
        _BUILD_SHA.append(sha or None)
    return _BUILD_SHA[0]


def health_snapshot() -> dict:
    """The /healthz payload: the newest live frontend's breaker, ladder
    and queue depth at the top level (what an alerting rule matches),
    every live frontend under `frontends`, this process's ingest
    counters, the newest live router's fleet under `shards` and the
    newest live autoscaler under `autoscaler`."""
    reg = get_registry()
    out = {
        "status": "ok",
        "breaker": None,
        "ladder": None,
        "queue_depth": None,
        "frontends": [],
        "jobs_running": sum(1 for j in progress.jobs()
                            if j.state == "running"),
        "registry_seq": reg.seq,
        "uptime_s": round(time.time() - _PROCESS_START, 3),
        "started_at": _PROCESS_START_ISO,
        "build_sha": _build_sha(),
        "recompiles_last_60s": profiling.recompiles_last_60s(),
        "slow_queries_last_60s": querylog.slow_last_60s(),
        "ingest": {
            "wal_appends": reg.get("ingest.wal_appends"),
            "wal_fsyncs": reg.get("ingest.wal_fsyncs"),
            "wal_torn_tail_truncated": reg.get(
                "ingest.wal_torn_tail_truncated"),
            "wal_segments_retired": reg.get("ingest.wal_segments_retired"),
            "replayed": reg.get("ingest.replayed"),
            "lease_takeovers": reg.get("ingest.lease_takeovers"),
            "lease_conflicts": reg.get("ingest.lease_conflicts"),
            "flushes": reg.get("ingest.flushes"),
            "freshness_lag_ms": reg.gauges().get("ingest.freshness_lag_ms"),
        },
    }
    for fe in _live(_frontends):
        try:
            st = fe.stats()
        except Exception as e:  # noqa: BLE001 — health must not 500
            st = {"error": repr(e)}
        out["frontends"].append(st)
    routers = _live(_routers)
    if routers:
        # the newest live router's fleet (its worker polls TTL-cached)
        try:
            out["shards"] = routers[-1].health_summary()
        except Exception as e:  # noqa: BLE001 — health must not 500
            out["shards"] = {"error": repr(e)}
    scalers = _live(_autoscalers)
    if scalers:
        try:
            out["autoscaler"] = scalers[-1].snapshot()
        except Exception as e:  # noqa: BLE001 — health must not 500
            out["autoscaler"] = {"error": repr(e)}
    if out["frontends"]:
        latest = out["frontends"][-1]
        for key in ("breaker", "ladder", "queue_depth", "cache",
                    "generation", "batching"):
            out[key] = latest.get(key)
    return out


# -- the HTML pages ----------------------------------------------------------

_NAV_ROUTES = ("/healthz", "/jobs?format=html", "/cluster?format=html",
               "/profile?format=html", "/querylog?format=html",
               "/doctor?format=html", "/slo?format=html",
               "/timeseries?format=html", "/trace", "/flight", "/metrics")

ENDPOINTS = ("/metrics", "/metrics.json", "/healthz", "/jobs", "/jobs/<id>",
             "/profile", "/querylog", "/doctor", "/slo", "/trace",
             "/trace/<id>", "/timeseries", "/flight", "/cluster")

_STYLE = ("<style>body{font-family:sans-serif;margin:1em}"
          "table{border-collapse:collapse;margin:0 0 1.5em}"
          "td,th{border:1px solid #999;padding:2px 8px;text-align:left}"
          "th{background:#ddd}.pct{font-weight:bold}"
          "pre{background:#f4f4f4;padding:8px;overflow-x:auto}"
          ".nav{margin:0 0 1em}</style>")


def _nav_html() -> str:
    links = " &middot; ".join(
        f"<a href='{r}'>{html.escape(r.split('?')[0])}</a>"
        for r in _NAV_ROUTES)
    return f"<p class='nav'>{links}</p>"


def _json_page_html(title: str, obj) -> str:
    """A JSON payload as a page: the nav row and the indented JSON."""
    body = html.escape(json.dumps(obj, indent=2, default=repr))
    return ("<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title>{_STYLE}</head><body>"
            f"<h1>{html.escape(title)}</h1>{_nav_html()}"
            f"<pre>{body}</pre></body></html>")


def _timeseries_html(payload: dict) -> str:
    """/timeseries' page: one inline-SVG polyline a curated series a
    tier, the recent anomalies and the newest forecast fit."""
    parts = [
        "<!DOCTYPE html><html><head><meta charset='utf-8'>",
        f"<title>tpu-ir timeseries</title>{_STYLE}</head><body>",
        "<h1>tpu-ir timeseries</h1>", _nav_html(),
    ]
    if not payload.get("enabled"):
        parts.append("<p>timeseries disabled (TPU_IR_TIMESERIES=0)</p>"
                     "</body></html>")
        return "".join(parts)
    tiers = payload.get("tiers", [])
    parts.append("<p>" + " &middot; ".join(
        f"tier {t['tier']}: {t['window_s']:g}s &times; "
        f"{t['capacity']} ({t['len']} held)" for t in tiers) + "</p>")
    w, h = 360, 48
    for label in sorted(payload.get("series", {})):
        ent = payload["series"][label]
        cells = []
        for tier_pts in ent["tiers"]:
            vals = [v for _, v in tier_pts]
            if not vals:
                cells.append("<td>(no data)</td>")
                continue
            lo, hi = min(vals), max(vals)
            span = (hi - lo) or 1.0
            n = max(len(vals) - 1, 1)
            pts = " ".join(
                f"{i * w / n:.1f},{h - (v - lo) / span * h:.1f}"
                for i, v in enumerate(vals))
            cells.append(
                f"<td><svg width='{w}' height='{h}' "
                f"viewBox='0 0 {w} {h}'><polyline points='{pts}' "
                "fill='none' stroke='#36c' stroke-width='1.5'/></svg>"
                f"<br><small>last {vals[-1]:g} "
                f"[{lo:g}..{hi:g}]</small></td>")
        parts.append(f"<h3>{html.escape(label)}</h3>"
                     f"<table><tr>{''.join(cells)}</tr></table>")
    anomalies = payload.get("anomalies") or []
    if anomalies:
        rows = "".join(
            f"<tr><td>{html.escape(str(a['series']))}</td>"
            f"<td>{a['z']}</td><td>{a['value']}</td>"
            f"<td>{a['median']}</td></tr>" for a in anomalies)
        parts.append("<h3>anomalies</h3><table><tr><th>series</th>"
                     "<th>z</th><th>value</th><th>median</th></tr>"
                     f"{rows}</table>")
    fit = payload.get("forecast")
    if fit:
        parts.append(
            f"<p>forecast: period {fit['period_s']:g}s, amplitude "
            f"{fit['amplitude']:g}, r&sup2; {fit['r2']:g} &rarr; "
            f"occupancy {fit.get('forecast', 0.0):g} in "
            f"{fit.get('lead_s', 0.0):g}s</p>")
    parts.append("</body></html>")
    return "".join(parts)


def _jobs_html(job_dicts: list, title: str) -> str:
    """/jobs' page: a table a job, its name, state and percent above one
    row a phase with its task counts and counters."""
    parts = ["<!DOCTYPE html><html><head><meta charset='utf-8'>",
             f"<title>{html.escape(title)}</title>", _STYLE,
             f"</head><body><h1>{html.escape(title)}</h1>", _nav_html()]
    for d in job_dicts:
        eta = f" &middot; ETA {d['eta_s']}s" if "eta_s" in d else ""
        parts.append(
            f"<h2><a href='/jobs/{d['job_id']}?format=html'>"
            f"job_{d['job_id']:04d}</a> {html.escape(d['name'])} "
            f"({html.escape(d['kind'])})</h2>"
            f"<p>state: <b>{html.escape(d['state'])}</b> &middot; "
            f"<span class='pct'>{d['percent']}% complete</span> &middot; "
            f"{d['elapsed_s']}s elapsed{eta}</p>")
        parts.append("<table><tr><th>phase</th><th>done</th><th>total</th>"
                     "<th>%</th><th>counters</th></tr>")
        for ph in d["phases"]:
            counters = ", ".join(f"{k}={v}"
                                 for k, v in sorted(ph["counters"].items()))
            pct = f"{ph['percent']}%" if "percent" in ph else ""
            parts.append(
                f"<tr><td>{html.escape(ph['phase'])}</td>"
                f"<td>{ph['done']}</td>"
                f"<td>{'' if ph['total'] is None else ph['total']}</td>"
                f"<td>{pct}</td><td>{html.escape(counters)}</td></tr>")
        parts.append("</table>")
    if not job_dicts:
        parts.append("<p>(no jobs recorded)</p>")
    parts.append("</body></html>")
    return "".join(parts)


def _trace_waterfall_html(st: dict) -> str:
    """/trace/<id>'s page: one row a span, indented by depth, with its bar
    on the trace's shared timeline."""
    total = max(float(st.get("dur_ms") or 0.0), 1e-9)
    start0 = float(st.get("start_ms") or 0.0)
    rows = []

    def walk(node: dict, depth: int) -> None:
        off = max(0.0, float(node.get("start_ms") or start0) - start0)
        dur = float(node.get("dur_ms") or 0.0)
        left = round(100.0 * off / total, 2)
        width = max(round(100.0 * dur / total, 2), 0.3)
        label = ("&nbsp;" * (depth * 3)) + html.escape(
            str(node.get("name", "?")))
        attrs = node.get("attrs") or {}
        att = html.escape(", ".join(f"{k}={v}"
                                    for k, v in sorted(attrs.items())))
        err = " style='color:#b00'" if node.get("error") else ""
        rows.append(
            f"<tr><td{err}>{label}</td>"
            f"<td>{html.escape(str(node.get('service', '?')))}</td>"
            f"<td>{node.get('dur_ms', 0.0)}</td>"
            f"<td><div style='position:relative;height:12px;"
            f"background:#eee'><div style='position:absolute;"
            f"left:{left}%;width:{width}%;height:12px;background:#69c'>"
            f"</div></div></td><td>{att}</td></tr>")
        for c in node.get("children", ()):
            walk(c, depth + 1)

    for r in st.get("roots", ()):
        walk(r, 0)
    tid = html.escape(str(st.get("trace_id", "?")))
    services = html.escape(", ".join(st.get("services", ())))
    return ("<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>trace {tid}</title>{_STYLE}</head><body>"
            f"<h1>trace {tid}</h1>{_nav_html()}"
            f"<p>{st.get('span_count', 0)} spans &middot; "
            f"{st.get('dur_ms', 0.0)} ms &middot; services: {services}</p>"
            "<table style='width:100%'><tr><th>span</th><th>service</th>"
            "<th>ms</th><th style='width:45%'>waterfall</th>"
            "<th>attrs</th></tr>" + "".join(rows)
            + "</table></body></html>")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # the default prints to stderr
        logger.debug("obs-http: " + fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200) -> None:
        self._send(code, json.dumps(obj, default=repr).encode("utf-8"),
                   "application/json")

    def _html(self, page: str) -> None:
        self._send(200, page.encode("utf-8"), "text/html; charset=utf-8")

    def do_POST(self) -> None:  # noqa: N802 — the stdlib handler contract
        """/rpc/<name>: the server instance's handler of that name (two
        workers in one process keep separate tables), run under the
        caller's adopted trace context; its span records of that trace
        ride back on the answer (`_trace`), so the router stitches with no
        second round trip."""
        try:
            route = urlparse(self.path).path.rstrip("/")
            if not route.startswith("/rpc/"):
                self._json({"error": "unknown endpoint"}, code=404)
                return
            name = route[len("/rpc/"):]
            fn = self.server.rpc_handlers.get(name)
            if fn is None:
                self._json({"error": f"no rpc handler {name!r}"}, code=404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                length = 0
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
            except ValueError:
                self._json({"error": "malformed JSON body"}, code=400)
                return
            ctx = disttrace.adopt(self.headers.get("traceparent"))
            try:
                with disttrace.use(ctx):
                    out = fn(payload)
                if ctx is not None and isinstance(out, dict):
                    batch = disttrace.piggyback(ctx.trace_id)
                    if batch:
                        out["_trace"] = batch
            except Exception as e:  # noqa: BLE001 — classified below
                # a shed is structure (retry elsewhere), anything else a
                # replica failure
                from ..serving.admission import Overloaded

                if isinstance(e, Overloaded):
                    self._json({"error": "overloaded", "reason": e.reason,
                                "level": e.level}, code=503)
                else:
                    self._json({"error": repr(e)}, code=500)
                return
            self._json(out)
        except BrokenPipeError:
            pass  # the caller hung up mid-response
        except Exception as e:  # noqa: BLE001 — an RPC never kills the
            try:                # process it runs in
                self._json({"error": repr(e)}, code=500)
            except Exception:  # noqa: BLE001
                pass

    def do_GET(self) -> None:  # noqa: N802 — the stdlib handler contract
        try:
            url = urlparse(self.path)
            route = url.path.rstrip("/") or "/"
            q = parse_qs(url.query)
            as_html = q.get("format", [""])[0] == "html"
            if route == "/metrics":
                if q.get("reset"):
                    self._json({"error": "scrapes are read-only; reset "
                                "from the owning process (tpu-ir-torch "
                                "metrics --reset)"}, code=403)
                    return
                self._send(200,
                           get_registry().prometheus_text().encode("utf-8"),
                           "text/plain; version=0.0.4")
            elif route == "/metrics.json":
                self._json(get_registry().snapshot())
            elif route == "/profile":
                report = profiling.profile_report()
                if as_html:
                    self._html(_json_page_html("tpu-ir profile", report))
                else:
                    self._json(report)
            elif route == "/doctor":
                payload = _doctor_payload(q)
                if as_html:
                    self._html(_json_page_html("tpu-ir doctor", payload))
                else:
                    self._json(payload)
            elif route == "/":
                self._json({"endpoints": list(ENDPOINTS)})
            elif route == "/healthz":
                payload = health_snapshot()
                extra = self.server.extra_health
                if extra is not None:
                    payload.update(extra() if callable(extra) else extra)
                self._json(payload)
            elif route == "/jobs":
                dicts = [j.to_dict() for j in reversed(progress.jobs())]
                if as_html:
                    self._html(_jobs_html(dicts, "tpu-ir jobs"))
                else:
                    self._json({"jobs": dicts})
            elif route.startswith("/jobs/"):
                try:
                    job = progress.get_job(int(route.split("/", 2)[2]))
                except ValueError:
                    job = None
                if job is None:
                    self._json({"error": "no such job"}, code=404)
                elif as_html:
                    d = job.to_dict()
                    self._html(_jobs_html([d],
                                          f"tpu-ir job_{d['job_id']:04d}"))
                else:
                    self._json(job.to_dict())
            elif route == "/querylog":
                n = None
                if q.get("n"):
                    try:
                        n = max(int(q["n"][0]), 1)
                    except ValueError:
                        self._json({"error": "n must be an integer"},
                                   code=400)
                        return
                payload = {**querylog.summary(),
                           "slow_entries": querylog.slow_recent(n)}
                if q.get("slow", ["0"])[0] in ("", "0", "false"):
                    payload["entries"] = querylog.recent(n)
                if as_html:
                    self._html(_json_page_html("tpu-ir querylog", payload))
                else:
                    self._json(payload)
            elif route == "/flight":
                self._json({"flight_records": recent_headers()})
            elif route == "/slo":
                slo = disttrace.slo_snapshot()
                if as_html:
                    self._html(_json_page_html("tpu-ir slo", slo))
                else:
                    self._json(slo)
            elif route == "/trace":
                self._json({"traces": disttrace.trace_ids()})
            elif route.startswith("/trace/"):
                tid = route.split("/", 2)[2]
                st = disttrace.stitch(tid)
                if st is None:
                    self._json({"error": f"no trace {tid!r}"}, code=404)
                elif as_html:
                    self._html(_trace_waterfall_html(st))
                else:
                    self._json(st)
            elif route == "/timeseries":
                from . import timeseries

                cluster = q.get("cluster", ["0"])[0] not in ("", "0")
                payload = timeseries.payload(cluster=cluster)
                if as_html:
                    self._html(_timeseries_html(payload))
                else:
                    self._json(payload)
            elif route == "/cluster":
                from . import aggregate

                if not aggregate.spool_dir():
                    self._json({"error": "TPU_IR_TELEMETRY_DIR not set"},
                               code=404)
                    return
                merged = aggregate.merge_spool(include_local=True)
                if as_html:
                    self._html(_json_page_html("tpu-ir cluster", merged))
                else:
                    self._json(merged)
            else:
                self._json({"error": "unknown endpoint"}, code=404)
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001 — a scrape never kills the
            try:                # process it observes
                self._json({"error": repr(e)}, code=500)
            except Exception:  # noqa: BLE001
                pass


class MetricsServer:
    """Bind, serve on a named daemon thread, stop cleanly. `rpc_handlers`
    (name -> fn(payload) -> dict) and `extra_health` (a dict, or a
    callable returning one, merged into /healthz) belong to this
    instance. A running server holds one reference on the timeseries
    sampler and, when `spool` (default: TPU_IR_TELEMETRY_DIR is set),
    runs a SpoolWriter."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 spool: bool | None = None,
                 rpc_handlers: dict | None = None, extra_health=None):
        from . import aggregate

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.rpc_handlers = dict(rpc_handlers or {})
        self._httpd.extra_health = extra_health
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None
        want_spool = (spool if spool is not None
                      else aggregate.spool_dir() is not None)
        self._spool = aggregate.SpoolWriter() if want_spool else None
        self._ts_ref = False

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MetricsServer":
        if self._thread is None:
            from . import timeseries

            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.1},
                name=f"tpu-ir-obs-http-{self.port}", daemon=True)
            self._thread.start()
            if self._spool is not None:
                self._spool.start()
            self._ts_ref = timeseries.ensure_sampler() is not None
        return self

    def stop(self) -> None:
        """Stop accepting, close the socket, join the serve thread, stop
        the spool writer (it writes its last record) and release the
        sampler; idempotent."""
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=10.0)
            self._thread = None
        self._httpd.server_close()
        if self._spool is not None:
            self._spool.stop()
            self._spool = None
        if self._ts_ref:
            from . import timeseries

            self._ts_ref = False
            timeseries.release_sampler()

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
