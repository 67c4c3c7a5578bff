"""Live /statsz endpoint (a copy of
``paddle_tpu/observability/statsz.py``): a threaded HTTP server that
scraping tools hit for the process's current stats snapshot. Opt-in:
set ``PT_STATSZ_PORT`` or call ``start_statsz()``.

Routes:
    /statsz         structured JSON: rank + counters/gauges/timers/
                    histograms (the ``stats.export()`` form, which
                    ``stats.merge`` takes)
    /statsz?flat=1  flat name->value map (``stats.snapshot()``)
    /metricsz       Prometheus text exposition (version 0.0.4) of the
                    same registry: counters as ``pt_<name>_total``,
                    gauges as ``pt_<name>``, histograms and timers as
                    summaries (``/metrics`` answers too)
    /               plain-text ``stats.table()``
"""

import json
import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlparse, parse_qs

__all__ = ["StatszServer", "start_statsz", "stop_statsz",
           "prometheus_text"]

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str, suffix: str = "") -> str:
    """``serve/ttft_s`` → ``pt_serve_ttft_s``: slashes/dots become
    underscores, everything lands under one ``pt_`` namespace."""
    return "pt_" + _PROM_BAD.sub("_", name) + suffix


def _prom_value(v) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def prometheus_text(registry) -> str:
    """Render a StatRegistry as Prometheus text exposition format
    (0.0.4). Typed from the registry's own taxonomy — counters are
    Prometheus counters (``_total``), gauges gauges, and the
    log-bucketed histograms and timers summaries (quantile samples are
    the registry's p50/p90/p99 estimates; a scraper averages
    *post-scrape* exactly as it would native summary quantiles)."""
    from paddle_tpu_torch import stats as _stats
    exp = registry.export()
    lines = []

    def emit(name, mtype, samples):
        lines.append(f"# TYPE {name} {mtype}")
        for label, v in samples:
            lines.append(f"{name}{label} {_prom_value(v)}")

    for k in sorted(exp.get("counters", {})):
        emit(_prom_name(k, "_total"), "counter",
             [("", exp["counters"][k])])
    for k in sorted(exp.get("gauges", {})):
        emit(_prom_name(k), "gauge", [("", exp["gauges"][k])])
    for k in sorted(exp.get("timers", {})):
        t = exp["timers"][k]
        n = _prom_name(k, "_seconds")
        lines.append(f"# TYPE {n} summary")
        lines.append(f"{n}_sum {_prom_value(t.get('total_s', 0.0))}")
        lines.append(f"{n}_count {_prom_value(t.get('count', 0))}")
    for k in sorted(exp.get("histograms", {})):
        h = _stats._Histogram.from_dict(exp["histograms"][k])
        n = _prom_name(k)
        samples = [(f'{{quantile="{q / 100}"}}', h.percentile(q))
                   for q in (50, 90, 99)]
        lines.append(f"# TYPE {n} summary")
        for label, v in samples:
            lines.append(f"{n}{label} {_prom_value(v)}")
        lines.append(f"{n}_sum {_prom_value(h.sum)}")
        lines.append(f"{n}_count {_prom_value(h.count)}")
    return "\n".join(lines) + "\n"

_server_lock = threading.Lock()
_server: Optional["StatszServer"] = None


class _Handler(BaseHTTPRequestHandler):
    def _registry(self):
        """The registry this server snapshots: the process default, or
        the server's ``registry`` provider (a StatRegistry or a
        callable returning one — the fleet /statsz serves a freshly
        merged registry per scrape this way)."""
        reg = getattr(self.server, "pt_registry", None)
        if reg is None:
            from paddle_tpu_torch import stats
            return stats.default_registry()
        return reg() if callable(reg) else reg

    def do_GET(self):  # noqa: N802 (http.server contract)
        reg = self._registry()
        u = urlparse(self.path)
        if u.path in ("/statsz", "/statsz/"):
            q = parse_qs(u.query)
            if q.get("flat"):
                body = json.dumps(reg.snapshot())
            else:
                body = json.dumps(reg.export())
            ctype = "application/json"
        elif u.path in ("/metricsz", "/metrics"):
            body = prometheus_text(reg)
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif u.path == "/":
            body = reg.table() + "\n"
            ctype = "text/plain; charset=utf-8"
        else:
            self.send_error(404, "try /statsz, /metricsz, or /")
            return
        data = body.encode()
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):  # quiet: scrapes must not spam stderr
        pass


class StatszServer:
    """ThreadingHTTPServer on a daemon thread; ``port=0`` binds an
    ephemeral port (read ``.port`` after construction — tests use
    this). ``registry`` overrides what is served: a StatRegistry, or a
    zero-arg callable returning one evaluated per scrape (the fleet
    /statsz serves ``FleetStats.merged`` through this)."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0",
                 registry=None):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.pt_registry = registry
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pt-statsz",
            daemon=True)
        self._thread.start()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def start_statsz(port: int = 0, host: str = "0.0.0.0") -> StatszServer:
    """Start (or return the already-running) statsz server."""
    global _server
    with _server_lock:
        if _server is None:
            _server = StatszServer(port, host)
        return _server


def stop_statsz():
    global _server
    with _server_lock:
        srv, _server = _server, None
    if srv is not None:
        srv.stop()
