"""The port's telemetry exporters, flight recorder, TensorBoard writer and
experiment channels, held against the JAX package's on the same inputs,
and their wiring into the port's CLI.

- ``prometheus_text`` of the same registry contents is byte-equal to
  JAX's; ``export_scalars`` flattens as JAX's does.
- A live ``TelemetryServer`` on an ephemeral port serves ``/metrics``,
  ``/json``, ``/flight?since=&kind=``, ``/trace`` and ``/``; the ``/trace``
  document validates through ``scripts/trace_dump.py``.
- A flight dump has JAX's document keys, never raises, stamps the trace in
  scope, and a SIGTERM to a process that installed the dump leaves
  ``flight-<pid>.json``.
- ``StatHolder``'s TensorBoard events read back with JAX's tags and
  values; ``channels.jsonl`` is line-equal to JAX's ``ExperimentLogger``.
- The fused trainer serves ``--telemetry_port`` and writes TensorBoard
  events and ``channels.jsonl``; ``--profiler_port`` exits with its
  message.
"""

from __future__ import annotations

import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from distributed_ba3c_tpu import telemetry as jtele
from distributed_ba3c_tpu.telemetry import recorder as jrec
from distributed_ba3c_tpu_torch import telemetry
from distributed_ba3c_tpu_torch.telemetry import recorder as prec
from distributed_ba3c_tpu_torch.telemetry import tracing as ptr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROM_LINE = re.compile(
    r"^ba3c_[A-Za-z0-9_]+(\{[A-Za-z0-9_]+=\"[^\"]*\"(,[A-Za-z0-9_]+=\"[^\"]*\")*\})? "
    r"[-+]?[0-9.eE+naninf-]+$"
)


def _assert_prom_parses(text: str) -> set:
    names = set()
    for line in text.strip().splitlines():
        if line.startswith("#"):
            assert line.startswith("# TYPE ba3c_"), line
            continue
        assert _PROM_LINE.match(line), f"unparseable metrics line: {line!r}"
        names.add(line.split("{")[0].split(" ")[0])
    return names


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read()


@pytest.fixture(autouse=True)
def _fresh_registries():
    """Leaves the port's registries empty and drops the JAX package's roles
    these tests made, so no later test of this process reads them."""
    yield
    telemetry.reset_all()
    from distributed_ba3c_tpu.telemetry import metrics as jmetrics

    with jmetrics._registries_lock:
        for role in [r for r in jmetrics._registries if r.endswith((".pt", ".ex"))]:
            del jmetrics._registries[role]


@pytest.fixture
def server():
    srv = telemetry.TelemetryServer(0, host="127.0.0.1")
    srv.start()
    yield f"http://127.0.0.1:{srv.port}"
    srv.stop()
    srv.join(timeout=5)
    srv.close()


# -- exporters -----------------------------------------------------------------


def _fill(tele, tag):
    """The same series in ``tele``'s registries, under roles of ``tag``."""
    tele.registry(f"master.{tag}").counter("a_total").inc(3)
    tele.registry(f"master.{tag}").counter("episodes_total").inc(2)
    tele.registry(f"fleet.{tag}").counter("episodes_total").inc(7)
    tele.registry(f"predictor.{tag}").gauge("depth", fn=lambda: 4)
    h = tele.registry(f"learner.{tag}").histogram("step_s")
    for v in (5e-5, 0.01, 0.01, 2.5):
        h.observe(v)
    tele.registry(f"learner.{tag}").histogram("hop_ingest_s", unit=1e-6).observe(3e-4)
    return {r: s for r, s in tele.all_snapshots().items() if r.endswith(f".{tag}")}


def test_prometheus_text_is_byte_equal_to_jax():
    got = telemetry.prometheus_text(_fill(telemetry, "pt"))
    want = jtele.prometheus_text(_fill(jtele, "pt"))
    assert got == want
    names = _assert_prom_parses(got)
    assert {"ba3c_a_total", "ba3c_depth", "ba3c_step_s_bucket", "ba3c_step_s_sum",
            "ba3c_step_s_count"} <= names
    # one TYPE line per family, whatever the roles
    assert got.count("# TYPE ba3c_episodes_total ") == 1


def test_export_scalars_matches_jax_layout():
    _fill(telemetry, "ex")
    _fill(jtele, "ex")
    got = {k: v for k, v in telemetry.export_scalars().items() if ".ex/" in k}
    want = {k: v for k, v in jtele.export_scalars().items() if ".ex/" in k}
    assert got == want
    assert got["tele/master.ex/a_total"] == 3
    assert got["tele/learner.ex/step_s_count"] == 4


def test_telemetry_server_endpoints(server, tmp_path):
    telemetry.registry("master").counter("served_total").inc(3)
    ptr.set_sampling(1)
    try:
        ptr.TraceRef(99, 1).hop("wire", "master").hop("master_ingest", "master")
        t_mid = time.monotonic()
        telemetry.record("prune", ident="x")
        telemetry.record("queue_wait", wait_s=0.1)
        text = _get(f"{server}/metrics").decode()
        _assert_prom_parses(text)
        assert 'ba3c_served_total{role="master"}' in text
        assert 'ba3c_hop_wire_s_count{role="master"}' in text
        snap = json.loads(_get(f"{server}/json"))
        assert snap["master"]["served_total"]["value"] >= 3
        doc = json.loads(_get(f"{server}/trace"))
        assert doc["sample_n"] == 1 and any(s["trace_id"] == 99 for s in doc["spans"])
        assert {"pid", "anchor_monotonic_us", "anchor_wall", "clock_offsets_us",
                "dropped_spans"} <= set(doc)
        assert {e["kind"] for e in json.loads(_get(f"{server}/flight?kind=prune"))} == {"prune"}
        since = json.loads(_get(f"{server}/flight?since={t_mid}"))
        assert {e["kind"] for e in since} == {"prune", "queue_wait"}
        both = json.loads(_get(f"{server}/flight?since={t_mid}&kind=queue_wait"))
        assert [e["kind"] for e in both] == ["queue_wait"]
        assert isinstance(json.loads(_get(f"{server}/flight?since=junk")), list)
        assert len(json.loads(_get(f"{server}/flight"))) >= 2
        assert b"/metrics" in _get(f"{server}/")
        with pytest.raises(urllib.error.HTTPError):
            _get(f"{server}/nope")
    finally:
        ptr.set_sampling(0)
        ptr.reset()
    # the /trace document through the repo's renderer, as a subprocess
    (tmp_path / "t.json").write_bytes(json.dumps(doc).encode())
    r = subprocess.run([sys.executable, "scripts/trace_dump.py", str(tmp_path / "t.json"),
                        "-o", str(tmp_path / "chrome.json"), "--validate"],
                       capture_output=True, text=True, cwd=REPO, timeout=60)
    assert r.returncode == 0, r.stderr
    events = json.loads((tmp_path / "chrome.json").read_text())["traceEvents"]
    assert {e["name"] for e in events if e.get("ph") == "X"} >= {"wire", "master_ingest"}


def test_telemetry_server_follows_the_startable_protocol():
    srv = telemetry.TelemetryServer(0, host="127.0.0.1")
    # never started: stop/join/close must not wedge (a teardown after an
    # earlier startable failed)
    srv.stop()
    srv.join(timeout=1)
    srv.close()


# -- flight recorder -------------------------------------------------------------


def test_flight_dump_has_the_jax_document(tmp_path):
    docs = {}
    for name, mod in (("jax", jrec), ("port", prec)):
        rec = mod.FlightRecorder(capacity=4)
        for i in range(7):
            rec.record("evt", i=i)
        assert [e["i"] for e in rec.snapshot()] == [3, 4, 5, 6]
        path = rec.dump("test", path=str(tmp_path / f"{name}.json"))
        docs[name] = json.loads(open(path).read())
    assert set(docs["port"]) == set(docs["jax"]) == {
        "reason", "pid", "dumps", "anchor_monotonic", "anchor_wall", "events"}
    strip = [{k: v for k, v in e.items() if k != "t_monotonic"} for e in docs["port"]["events"]]
    assert strip == [{k: v for k, v in e.items() if k != "t_monotonic"}
                     for e in docs["jax"]["events"]]
    assert docs["port"]["reason"] == "test" and docs["port"]["dumps"] == 1


def test_flight_dump_never_raises_and_stamps_the_trace(tmp_path):
    rec = prec.FlightRecorder()
    rec.record("evt")
    assert rec.dump("x", path="/proc/nope/flight.json") is None
    with ptr.trace_scope(31337):
        rec.record("in_scope")
    rec.record("out_of_scope")
    by = {e["kind"]: e for e in rec.snapshot()}
    assert by["in_scope"]["trace_id"] == 31337 and "trace_id" not in by["out_of_scope"]
    t0 = rec.events_since(0.0)[0][0]
    assert [ev[1] for ev in rec.events_since(t0)] == ["in_scope", "out_of_scope"]
    assert [ev[1] for ev in rec.events_since(0.0, "in_scope")] == ["in_scope"]
    # the module-level ring keeps today's callers working
    telemetry.record("legacy_kind", a=1)
    assert telemetry.recorded("legacy_kind")[-1]["a"] == 1


def test_flight_dump_lands_in_the_configured_dir(tmp_path):
    telemetry.configure(str(tmp_path))
    try:
        path = telemetry.dump("configured")
    finally:
        telemetry.configure(None)
    assert path == str(tmp_path / f"flight-{os.getpid()}.json")
    assert json.loads(open(path).read())["reason"] == "configured"


SIGTERM_CHILD = """
import os, signal, sys, time
from distributed_ba3c_tpu_torch import telemetry
telemetry.configure(sys.argv[1])
telemetry.install_signal_dump()
telemetry.record("before_term", n=1)
os.kill(os.getpid(), signal.SIGTERM)
time.sleep(30)
"""


def test_sigterm_leaves_a_flight_dump(tmp_path):
    p = subprocess.run([sys.executable, "-c", SIGTERM_CHILD, str(tmp_path)], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO), timeout=60,
                       capture_output=True, text=True)
    assert p.returncode == -signal.SIGTERM, p.stderr[-2000:]
    dumps = [f for f in os.listdir(tmp_path) if re.fullmatch(r"flight-\d+\.json", f)]
    assert len(dumps) == 1
    doc = json.loads((tmp_path / dumps[0]).read_text())
    assert doc["reason"] == "SIGTERM" and str(doc["pid"]) in dumps[0]
    assert [e["kind"] for e in doc["events"]] == ["before_term", "sigterm"]


# -- TensorBoard and channels ------------------------------------------------------


RECORDS = [
    {"epoch": 1.0, "global_step": 20.0, "fps": 123.5, "loss": 0.75, "mean_score": -21.0},
    {"epoch": 2.0, "global_step": 40.0, "fps": 130.25, "loss": 0.5, "max_score": -19.0,
     "tele/learner/train_steps_total": 40.0},
]


def _events(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return {t: [(e.step, e.value) for e in acc.Scalars(t)] for t in acc.Tags()["scalars"]}


def test_stat_holder_tensorboard_events_match_jax(tmp_path):
    from distributed_ba3c_tpu.utils.stats import StatHolder as JStatHolder
    from distributed_ba3c_tpu_torch.utils.stats import StatHolder

    for cls, d in ((StatHolder, tmp_path / "port"), (JStatHolder, tmp_path / "jax")):
        h = cls(str(d))
        for rec in RECORDS:
            h.add_stats(rec)
            h.finalize()
        h.close()
    got, want = _events(tmp_path / "port"), _events(tmp_path / "jax")
    assert got == want
    assert set(got) == {k for r in RECORDS for k in r if k != "global_step"}
    assert got["fps"] == [(20, 123.5), (40, 130.25)]
    assert (json.loads((tmp_path / "port" / "stat.json").read_text())
            == json.loads((tmp_path / "jax" / "stat.json").read_text()))


def test_tb_writer_warns_without_tensorboard(tmp_path, monkeypatch):
    import builtins

    from distributed_ba3c_tpu_torch.utils import tb_writer

    real_import = builtins.__import__

    def no_tb(name, *a, **kw):
        if name.startswith("tensorboard"):
            raise ImportError("no tensorboard")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tb)
    w = tb_writer.TBScalarWriter(str(tmp_path))
    w.add_scalars({"fps": 1.0}, 1)
    w.flush()
    w.close()
    assert not os.listdir(tmp_path)


def test_channels_jsonl_is_line_equal_to_jax(tmp_path, monkeypatch):
    from distributed_ba3c_tpu.train import experiment as jexp
    from distributed_ba3c_tpu.utils.stats import StatHolder as JStatHolder
    from distributed_ba3c_tpu_torch.train import experiment as pexp
    from distributed_ba3c_tpu_torch.utils.stats import StatHolder

    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.5)

    class _Trainer:
        def __init__(self, log_dir, holder_cls):
            self.config = type("C", (), {"log_dir": str(log_dir)})()
            self.stat_holder = holder_cls(None)
            self.global_step = 0

    for mod, holder_cls, d in ((pexp, StatHolder, tmp_path / "port"),
                               (jexp, JStatHolder, tmp_path / "jax")):
        cb = mod.ExperimentLogger()
        cb.setup(_Trainer(d, holder_cls))
        cb.before_train()
        for rec in RECORDS:
            cb.trainer.stat_holder.add_stats(rec)
            cb.trainer.stat_holder.finalize()
            cb.trigger_epoch()
        cb.after_train()
    got = (tmp_path / "port" / "channels.jsonl").read_text().splitlines()
    assert got == (tmp_path / "jax" / "channels.jsonl").read_text().splitlines()
    assert [json.loads(x)["channel"] for x in got] == [
        "mean_score", "fps", "loss", "max_score", "fps", "loss"]


# -- the CLI --------------------------------------------------------------------


def test_profiler_port_exits_naming_capture_trace():
    from distributed_ba3c_tpu_torch import cli

    with pytest.raises(SystemExit, match="capture_trace"):
        cli.main(["--profiler_port", "9012", "--device", "cpu"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_fused_trainer_serves_telemetry_and_writes_tb_and_channels(tmp_path):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_ba3c_tpu_torch", "--task", "train",
         "--trainer", "tpu_fused_ba3c", "--env", "jax:pong", "--fc_units", "16",
         "--batch_size", "6", "--rollout_len", "3", "--steps_per_epoch", "2",
         "--max_epoch", "3", "--eval_max_steps", "5", "--telemetry_port", str(port),
         "--device", "cpu", "--logdir", str(tmp_path)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    scraped = None
    try:
        deadline = time.monotonic() + 200
        while proc.poll() is None and time.monotonic() < deadline:
            try:
                text = _get(f"http://127.0.0.1:{port}/metrics").decode()
            except OSError:
                time.sleep(0.2)
                continue
            if 'ba3c_train_steps_total{role="learner"}' in text:
                scraped = text
                break
            time.sleep(0.2)
        _, err = proc.communicate(timeout=200)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    assert proc.returncode == 0, err[-3000:]
    assert scraped is not None, "the learner's counters were never served"
    _assert_prom_parses(scraped)
    stats = json.loads((tmp_path / "stat.json").read_text())
    tags = set(_events(tmp_path))
    assert tags == {k for r in stats for k in r if k != "global_step"}
    points = [json.loads(x) for x in (tmp_path / "channels.jsonl").read_text().splitlines()]
    assert [(p["channel"], p["x"]) for p in points if p["channel"] == "loss"] == [
        ("loss", 2.0), ("loss", 4.0), ("loss", 6.0)]
    assert [p["y"] for p in points if p["channel"] == "fps"] == [r["fps"] for r in stats]
    assert np.isfinite([p["y"] for p in points if p["channel"] == "loss"]).all()
