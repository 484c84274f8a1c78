"""Flight recorder: a fixed-size ring of structured events + postmortem dump.

A copy of ``distributed_ba3c_tpu/telemetry/recorder.py``. The recorder
keeps the last ``capacity`` structured events in memory (a
``deque(maxlen=...)`` append is GIL-atomic, no lock on the record path) and
writes them all out as one JSON file, ``flight-<pid>.json`` in the
configured directory (``--logdir``, or ``BA3C_FLIGHT_DIR`` in a spawned
child), when something dies: SIGTERM (:func:`install_signal_dump`), an
actor prune and a client drop in the master (actors/simulator.py), or any
explicit :func:`dump` call.

Event kinds the port records: ``prune``, ``client_drop``,
``corrupt_frame``, ``per_env_reject``, ``block_reject``,
``incarnation_reset``, ``ring_attach``, ``queue_wait``,
``shed_no_fallback``, ``predictor_callback_error``,
``staging_acquire_stall``, ``checkpoint``, ``sigterm``.

Timestamps are ``time.monotonic()`` (the wall clock jumps); each dump
carries one (monotonic, wall) anchor pair so offline tooling can map event
times to wall time.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time
from typing import Optional

from distributed_ba3c_tpu_torch.telemetry import metrics as _metrics
from distributed_ba3c_tpu_torch.telemetry import tracing as _tracing

DEFAULT_CAPACITY = 4096

_dump_dir: Optional[str] = os.environ.get("BA3C_FLIGHT_DIR") or None


def configure(dump_dir: Optional[str]) -> None:
    """Set where postmortem dumps land (cli.py points this at --logdir;
    the ``BA3C_FLIGHT_DIR`` env var seeds it for child processes)."""
    global _dump_dir
    _dump_dir = dump_dir


class FlightRecorder:
    """The ring. One per process is plenty (events carry their component)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._dumps = 0
        # serializes DUMPS only (two failure paths racing a file write);
        # record() never takes it
        self._dump_lock = threading.Lock()

    def record(self, kind: str, **fields) -> None:
        """Append one event — a single deque append, safe from any thread.

        When a sampled trace is in scope on this thread (tracing.py
        ``trace_scope``), the event is stamped with its trace id so a
        postmortem dump correlates with the ``/trace`` spans — one
        thread-local read on the record path, nothing more."""
        if not _metrics.enabled():
            return
        tr = _tracing.current_trace_id()
        if tr is not None and "trace_id" not in fields:
            fields["trace_id"] = tr
        self._ring.append((time.monotonic(), kind, fields))

    def snapshot(self) -> list:
        """The ring's current events, oldest first, as JSON-ready dicts."""
        return [
            {"t_monotonic": t, "kind": kind, **fields}
            for t, kind, fields in list(self._ring)
        ]

    def events_since(self, t: float, kind: Optional[str] = None) -> list:
        """Raw ``(t_monotonic, kind, fields)`` tuples newer than ``t``,
        oldest first — the cheap polling read (no dict building) the fleet
        supervisor uses to watch the master's prune stream without keeping
        its own duplicate heartbeats (orchestrate/supervisor.py). ``kind``
        filters to one event kind."""
        return [
            ev
            for ev in list(self._ring)
            if ev[0] > t and (kind is None or ev[1] == kind)
        ]

    def dump(
        self, reason: str, path: Optional[str] = None, quiet: bool = False,
    ) -> Optional[str]:
        """Write the whole ring as one JSON file; returns the path.

        Never raises — a failing postmortem writer must not mask the
        failure being postmortemed. Repeated dumps overwrite the same file
        (the ring always contains the most recent history; ``dumps`` counts
        how many times evidence was written).

        ``quiet=True`` is the signal-handler mode (install_signal_dump):
        no logger call — the logging module's handler locks are not
        reentrant, and a SIGTERM delivered while the main thread holds one
        must lose the log line, not deadlock the process.
        """
        try:
            # timeout, not a bare acquire: a signal handler interrupting a
            # frame that already holds this lock would otherwise deadlock
            # the main thread forever (the holder can never resume)
            if not self._dump_lock.acquire(timeout=2.0):
                return None
            try:
                self._dumps += 1
                if path is None:
                    d = _dump_dir or tempfile.gettempdir()
                    os.makedirs(d, exist_ok=True)
                    path = os.path.join(
                        d, f"flight-{os.getpid()}.json"
                    )
                doc = {
                    "reason": reason,
                    "pid": os.getpid(),
                    "dumps": self._dumps,
                    # anchor pair: map monotonic event times to wall time
                    "anchor_monotonic": time.monotonic(),
                    "anchor_wall": time.time(),
                    "events": self.snapshot(),
                }
                tmp = f"{path}.tmp-{os.getpid()}"
                with open(tmp, "w") as fh:
                    json.dump(doc, fh)
                os.replace(tmp, path)
            finally:
                self._dump_lock.release()
            if not quiet:
                from distributed_ba3c_tpu_torch.utils import logger

                logger.warn(
                    "flight recorder dumped %d events to %s (reason: %s)",
                    len(doc["events"]), path, reason,
                )
            return path
        except Exception:
            return None


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def flight_recorder() -> FlightRecorder:
    """The process's recorder (get-or-create)."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def record(kind: str, **fields) -> None:
    """Module-level convenience: record on the process recorder."""
    flight_recorder().record(kind, **fields)


def dump(reason: str, path: Optional[str] = None) -> Optional[str]:
    """Module-level convenience: dump the process recorder (never raises)."""
    return flight_recorder().dump(reason, path)


def install_signal_dump() -> None:
    """Chain a SIGTERM handler that dumps the ring before the old handler
    (or default exit) runs — a launcher's stall-kill leaves evidence.
    Main-thread only (signal module restriction); no-op elsewhere."""
    import signal

    if threading.current_thread() is not threading.main_thread():
        return
    # materialize the singleton BEFORE the handler can run: a SIGTERM
    # landing inside flight_recorder()'s creation lock would deadlock the
    # handler's own flight_recorder() call on this same thread
    flight_recorder()
    prev = signal.getsignal(signal.SIGTERM)

    def _on_term(signum, frame):
        record("sigterm")
        flight_recorder().dump("SIGTERM", quiet=True)
        if prev is signal.SIG_IGN:
            # the run was launched with SIGTERM ignored (SIG_IGN survives
            # exec): keep ignoring after the dump — chaining to "default"
            # here would INVERT the disposition and kill the process
            return
        if callable(prev):
            prev(signum, frame)
        else:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    signal.signal(signal.SIGTERM, _on_term)
