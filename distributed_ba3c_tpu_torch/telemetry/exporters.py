"""Exporters: the scrape endpoint + stat.json/TB bridge.

A copy of ``distributed_ba3c_tpu/telemetry/exporters.py``.

:class:`TelemetryServer` is a stdlib ``http.server`` on ``--telemetry_port``
serving every role registry in the process (master, predictor, learner,
fleet):

- ``GET /metrics`` — Prometheus text exposition (``ba3c_*`` series, one
  ``role`` label; histograms as cumulative ``_bucket{le=...}`` +
  ``_sum``/``_count``).
- ``GET /json``    — the raw :func:`metrics.all_snapshots` document.
- ``GET /flight``  — the flight recorder's current ring (live, no dump);
  ``?since=<t_monotonic>&kind=<kind>`` filters via ``events_since``.
- ``GET /trace``   — the trace plane's buffered spans + clock offsets
  (telemetry/tracing.py; feed to ``scripts/trace_dump.py``).
- ``GET /``        — a one-line index.

The stat.json/TB bridge is :func:`export_scalars` — StatPrinter folds it
into each epoch record, so existing dashboards keep reading stat.json/TB
events while scrapers move to the endpoint.
"""

from __future__ import annotations

import http.server
import json
import threading
import urllib.parse
from typing import Dict, Optional

from distributed_ba3c_tpu_torch.telemetry import metrics, recorder, tracing


def prometheus_text(snapshots: Optional[Dict[str, Dict[str, dict]]] = None) -> str:
    """Render every registry as Prometheus text exposition format.

    Series are grouped per METRIC FAMILY (one ``# TYPE`` line, then every
    role's sample), not per (role, metric): the same name in two roles —
    ``episodes_total`` lives in learner, simulator and fleet by design —
    must not emit a second TYPE line, which the Prometheus text parser
    rejects for the whole scrape. A name that appears with conflicting
    types keeps the first type and drops the mismatched role's sample
    (rendering it would equally poison the scrape).
    """
    if snapshots is None:
        snapshots = metrics.all_snapshots()
    # family name -> [(role, collected)], insertion-ordered by sorted walk
    families: Dict[str, list] = {}
    for role, series in sorted(snapshots.items()):
        for name, m in sorted(series.items()):
            safe = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
            families.setdefault(safe, []).append((role, m))
    lines = []
    for safe in sorted(families):
        members = families[safe]
        ftype = members[0][1]["type"]
        lines.append(f"# TYPE ba3c_{safe} {ftype}")
        for role, m in members:
            if m["type"] != ftype:
                continue
            if m["type"] in ("counter", "gauge"):
                lines.append(f'ba3c_{safe}{{role="{role}"}} {m["value"]}')
            else:  # histogram: cumulative le-buckets over the log2 bounds
                unit, cum = m["unit"], 0
                for i, c in enumerate(m["buckets"]):
                    cum += c
                    if c:
                        le = unit * (1 << i)
                        lines.append(
                            f'ba3c_{safe}_bucket{{role="{role}",le="{le:g}"}} {cum}'
                        )
                lines.append(
                    f'ba3c_{safe}_bucket{{role="{role}",le="+Inf"}} {m["count"]}'
                )
                lines.append(f'ba3c_{safe}_sum{{role="{role}"}} {m["sum"]}')
                lines.append(f'ba3c_{safe}_count{{role="{role}"}} {m["count"]}')
    return "\n".join(lines) + "\n"


def export_scalars(
    roles=("master", "predictor", "router", "learner", "fleet",
           "orchestrator", "pod"),
    prefix: str = "tele/",
) -> Dict[str, float]:
    """Counters + gauges flattened to ``{"tele/<role>/<name>": value}`` for
    the stat.json/TB writers (histograms export their _count/_sum).

    Each requested role matches itself AND its dotted sub-roles: the
    per-fleet scheme (``master`` also exports ``master.f0``/``master.f1``
    — telemetry.fleet_role) and the pod's per-host scheme (``pod``
    exports ``pod.host0``/``pod.host1``/... — pod/wire.py pod_role, the
    learner-side mirror of each actor host's progress), so multi-fleet
    and pod runs grow their per-component series without every caller
    enumerating fleets or hosts.
    """
    out: Dict[str, float] = {}
    regs = metrics.all_registries()
    for base in roles:
        for role in sorted(regs):
            if role != base and not role.startswith(f"{base}."):
                continue
            for name, v in regs[role].scalars().items():
                out[f"{prefix}{role}/{name}"] = v
    return out


class _Handler(http.server.BaseHTTPRequestHandler):
    def _send(self, body: str, content_type: str) -> None:
        data = body.encode()
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 (stdlib API name)
        try:
            path, _, query = self.path.partition("?")
            if path.startswith("/metrics"):
                self._send(prometheus_text(), "text/plain; version=0.0.4")
            elif path.startswith("/json"):
                self._send(
                    json.dumps(metrics.all_snapshots()), "application/json"
                )
            elif path.startswith("/flight"):
                self._send(json.dumps(self._flight(query)), "application/json")
            elif path.startswith("/trace"):
                # the trace plane's scrape: buffered spans + per-peer
                # clock offsets + the monotonic/wall anchor pair —
                # scripts/trace_dump.py merges one or more of these into
                # Chrome trace-event / Perfetto JSON
                self._send(
                    json.dumps(tracing.tracer().document()),
                    "application/json",
                )
            elif path == "/":
                self._send(
                    "ba3c telemetry: /metrics (prometheus), /json, "
                    "/flight[?since=&kind=], /trace\n",
                    "text/plain",
                )
            else:
                self.send_error(404)
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper went away mid-response

    @staticmethod
    def _flight(query: str) -> list:
        """The flight ring, optionally filtered: ``?since=<t_monotonic>``
        and/or ``?kind=<event kind>`` expose the recorder's existing
        ``events_since`` filter over HTTP — a postmortem poll that wants
        "prunes since my last scrape" no longer re-downloads (and
        re-diffs) the whole ring. Junk params read as unfiltered/ignored
        rather than erroring the scrape."""
        params = urllib.parse.parse_qs(query)
        kind = params.get("kind", [None])[0] or None
        since = params.get("since", [None])[0]
        if since is None and kind is None:
            return recorder.flight_recorder().snapshot()
        try:
            t = float(since) if since is not None else float("-inf")
        except ValueError:
            t = float("-inf")
        return [
            {"t_monotonic": ev[0], "kind": ev[1], **ev[2]}
            for ev in recorder.flight_recorder().events_since(t, kind)
        ]

    def log_message(self, fmt, *args):  # scrapes must not spam the run log
        pass


class TelemetryServer:
    """The scrape endpoint, start/stop/join/close-compatible with
    StartProcOrThread (train/callbacks.py) so cli.py can just append it to
    the startables list."""

    def __init__(self, port: int, host: str = "0.0.0.0"):
        # ThreadingHTTPServer: a wedged scraper connection must not block
        # the next scrape. daemon_threads so per-request threads never
        # outlive the process.
        self._httpd = http.server.ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]  # resolved when port=0
        from distributed_ba3c_tpu_torch.utils.concurrency import StoppableThread

        # the loop is serve_forever, unblocked by shutdown() in stop() —
        # the StoppableThread flag is for StartProcOrThread's protocol
        self._thread = StoppableThread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.2},
            daemon=True,
            name="telemetry-scrape",
        )

    def start(self) -> None:
        self._thread.start()
        from distributed_ba3c_tpu_torch.utils import logger

        logger.info(
            "telemetry scrape endpoint on :%d "
            "(/metrics, /json, /flight, /trace)",
            self.port,
        )

    def stop(self) -> None:
        self._thread.stop()
        # shutdown() blocks on an event only serve_forever() sets — calling
        # it on a server whose thread never started (teardown after an
        # earlier startable failed to start) would wedge forever
        if self._thread.is_alive():
            self._httpd.shutdown()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread.is_alive():
            self._thread.join(timeout)

    def close(self) -> None:
        self._httpd.server_close()
