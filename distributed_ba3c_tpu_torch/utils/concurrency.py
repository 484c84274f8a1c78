"""Thread and process helpers for the serving and actor planes.

The subset of ``distributed_ba3c_tpu/utils/concurrency.py`` that the
predictor and the actor plane use, copied: :class:`FastQueue`,
:class:`StoppableThread`, :func:`queue_put_stoppable`, and the child
process helpers :func:`ensure_proc_terminate`, :func:`mask_sigint` and
:func:`start_proc_mask_signal`. Concurrency safety is by construction, as
there: queues between threads, no shared mutable state.
"""

from __future__ import annotations

import atexit
import collections
import multiprocessing as mp
import queue
import signal
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Iterable, Optional, Union


class FastQueue:
    """Bounded FIFO without locks or condition variables.

    ``queue.Queue`` takes a mutex and signals a condition variable on every
    operation; under producer/consumer contention each op degrades to a
    futex syscall. On sandboxed kernels where syscalls are expensive (one such
    host: measured 37-56 us PER PUT at plane rates — more than the
    whole block wire's per-datapoint budget), that makes ``queue.Queue``
    itself the actor plane's throughput ceiling (~20k items/s).

    This queue uses a plain ``collections.deque`` — ``append``/``popleft``
    are GIL-atomic, ~0.2 us — and bounded SLEEP-POLLING instead of
    condition variables when empty/full. The trade: a few ms of wakeup
    latency when a side actually has to wait, which is the right deal for
    a queue that is never supposed to be empty or full in steady state
    (the train queue at 40k+ datapoints/s).

    Implements the ``queue.Queue`` subset the actor plane uses (``put``/
    ``get`` with block/timeout, ``*_nowait``, ``qsize``/``empty``/``full``,
    ``maxsize``). The bound is approximate under multiple producers (two
    racing puts can overshoot by one item each) — backpressure, not an
    exact invariant.
    """

    _POLL_S = 0.002

    def __init__(self, maxsize: int = 0):
        self.maxsize = maxsize
        self._d: collections.deque = collections.deque()

    def qsize(self) -> int:
        return len(self._d)

    def empty(self) -> bool:
        return not self._d

    def full(self) -> bool:
        return self.maxsize > 0 and len(self._d) >= self.maxsize

    def put(self, item, block: bool = True, timeout: Optional[float] = None):
        if self.maxsize > 0 and len(self._d) >= self.maxsize:
            if not block:
                raise queue.Full
            deadline = (
                None if timeout is None else time.monotonic() + timeout
            )
            while len(self._d) >= self.maxsize:
                if deadline is not None and time.monotonic() >= deadline:
                    raise queue.Full
                time.sleep(self._POLL_S)
        self._d.append(item)

    def put_nowait(self, item):
        self.put(item, block=False)

    def get(self, block: bool = True, timeout: Optional[float] = None):
        try:
            return self._d.popleft()
        except IndexError:
            pass
        if not block:
            raise queue.Empty
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return self._d.popleft()
            except IndexError:
                if deadline is not None and time.monotonic() >= deadline:
                    raise queue.Empty
                time.sleep(self._POLL_S)

    def get_nowait(self):
        return self.get(block=False)


def queue_put_stoppable(
    q: queue.Queue, obj, stop_evt: threading.Event, timeout: float = 0.5
) -> bool:
    """Put, retrying until success or ``stop_evt``; returns False if stopped.

    The ONE sanctioned way to put on a bounded actor-plane queue: bounded
    waits that re-check the stop flag, so backpressure can never wedge
    shutdown (ba3clint rule A2).
    """
    while not stop_evt.is_set():
        try:
            q.put(obj, timeout=timeout)
            return True
        except queue.Full:
            pass
    return False


def queue_get_stoppable(
    q: queue.Queue, stop_evt: threading.Event, timeout: float = 0.5
):
    """Get, retrying until success or ``stop_evt``; returns None if stopped."""
    while not stop_evt.is_set():
        try:
            return q.get(timeout=timeout)
        except queue.Empty:
            pass
    return None


class StoppableThread(threading.Thread):
    """Thread with a cooperative stop flag and stop-aware queue helpers."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._stop_evt = threading.Event()

    def stop(self) -> None:
        self._stop_evt.set()

    def stopped(self) -> bool:
        return self._stop_evt.is_set()

    def queue_put_stoppable(self, q: queue.Queue, obj, timeout: float = 0.5) -> bool:
        """Put, retrying until success or stop(); returns False if stopped."""
        return queue_put_stoppable(q, obj, self._stop_evt, timeout)

    def queue_get_stoppable(self, q: queue.Queue, timeout: float = 0.5):
        """Get, retrying until success or stop(); returns None if stopped."""
        return queue_get_stoppable(q, self._stop_evt, timeout)


def ensure_proc_terminate(
    proc: Union[mp.Process, Iterable[mp.Process]],
) -> None:
    """Register an atexit hook that terminates the process(es): simulator
    processes must not outlive the trainer."""
    if not isinstance(proc, mp.process.BaseProcess):
        for p in proc:
            ensure_proc_terminate(p)
        return

    ref = weakref.ref(proc)

    def stop():
        p = ref()
        if p is None or not p.is_alive():
            return
        p.terminate()
        p.join(timeout=5)
        if p.is_alive():
            p.kill()

    atexit.register(stop)


@contextmanager
def mask_sigint():
    """Ignore SIGINT while children start, so they do not receive the
    trainer's Ctrl-C."""
    if threading.current_thread() is threading.main_thread():
        old = signal.signal(signal.SIGINT, signal.SIG_IGN)
        try:
            yield
        finally:
            signal.signal(signal.SIGINT, old)
    else:
        yield


def start_proc_mask_signal(
    procs: Union[mp.Process, Iterable[mp.Process]],
) -> None:
    """Start process(es) with SIGINT masked (children ignore Ctrl-C)."""
    if isinstance(procs, mp.process.BaseProcess):
        procs = [procs]
    with mask_sigint():
        for p in procs:
            p.start()
