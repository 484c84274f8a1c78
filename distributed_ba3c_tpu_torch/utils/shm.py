"""Shared-memory observation rings for the same-host block wire.

A copy of ``distributed_ba3c_tpu/utils/shm.py`` (the ring layout and the
name formula are the JAX package's, so a ring either side creates the
other can attach).

The ``block-shm`` wire (docs/actor_plane.md) keeps ZMQ for the CONTROL
plane — tiny header/rewards/dones messages and the int32 action replies —
and moves the observation bytes through a ``/dev/shm`` ring: the env server
writes each step's obs plane into ``ring[step % cap]`` and the master reads
frame-history WINDOWS of the ring as zero-copy numpy views.

Why not zmq frames for the obs too (the plain ``block`` wire)? On a normal
kernel they are fine; on sandboxed kernels with expensive syscalls (this
container: ~225 us per socket roundtrip, ~300-550 MB/s socket bandwidth,
measured) the obs bytes dominate the wire and cap the plane far below the
env core's rate. A ring write is one process-local memcpy; nothing else
ever copies.

Deliberately raw ``mmap`` over ``multiprocessing.shared_memory``: the
stdlib's resource tracker registers ATTACHED segments too (py3.10), so the
first process to exit unlinks a segment others still map. A file in
``/dev/shm`` has exactly the lifecycle we want: the creator unlinks it;
stale files from SIGKILLed creators are atomically RENAMED over at
re-create (never truncated in place — a master may still map the old
inode, and shrinking it would SIGBUS its next slot read).

Safety contract (enforced by the master at attach time): consumers must
drain experience fast enough that a datapoint's backing slot is not reused
— guaranteed when ``cap > (train_queue_maxsize + feed_holder) *
steps_per_item / B + flush_horizon + hist + margin`` because a full train
queue blocks the master, which stops action replies, which halts every
lockstep server within one step. Every term counts items that can still
pin ring views: the feed's collate holder took its items OUT of the queue
but holds views until its ``np.stack`` copies them (masters expose
``feed_batch`` for this), and a queued V-trace segment's
``bootstrap_state`` view trails the newest slot by a whole unroll
(``ring_steps_per_item = unroll_len``; 1 for BA3C datapoints).
"""

from __future__ import annotations

import glob
import mmap
import os

import numpy as np

SHM_DIR = "/dev/shm"


def min_safe_cap(
    b: int,
    queue_maxsize: int,
    feed_batch: int,
    steps_per_item: int,
    flush_horizon: int,
    hist: int,
    margin: int = 8,
) -> float:
    """Ring-capacity floor implied by the safety contract above.

    THE single definition of the formula — the master's attach-time check
    refuses any ring with ``cap <= min_safe_cap(...)`` and cli.py sizes the
    rings it creates from the same call, so the two sides cannot drift.
    Counts, in ring STEPS: every queued-or-held item that can pin a ring
    view ((queue + feed collate holder) x steps_per_item, spread over the
    block's B envs), the unflushed per-block step horizon, and the hist
    slots a frame-history window reaches back.
    """
    return (
        (queue_maxsize + feed_batch) * steps_per_item / max(1, b)
        + flush_horizon + hist + margin
    )


def available() -> bool:
    """The block-shm wire needs a writable /dev/shm (linux tmpfs)."""
    return os.path.isdir(SHM_DIR) and os.access(SHM_DIR, os.W_OK)


def ring_name(pipe_c2s: str, ident_prefix: str) -> str:
    """The canonical ring name for one fleet x server slot.

    THE single definition — the env server creates under this name
    (envs/native.py) and a supervisor reclaims stale files under it
    before a respawn (the JAX package's orchestrate/supervisor.py; the
    port has none yet); computing it in two places would let them drift and leak ~57 MB per crashed server. The
    name must be STABLE across restarts of a slot (pipe pair + prefix
    identify the slot; concurrent fleets differ in pipe address) so a
    crashed server's stale file is renamed over, not accumulated.
    """
    import hashlib

    fleet = hashlib.sha1(pipe_c2s.encode()).hexdigest()[:8]
    return f"ba3c-ring-{fleet}-{ident_prefix}"


def reclaim_stale(name: str) -> int:
    """Remove a stale ring file (any size/shape) and its orphaned create
    temps; returns how many files went away.

    Safe ONLY when no live server owns the name — the supervisor calls it
    with the slot's process known-dead. Unlinking (vs truncating) cannot
    hurt a master still mapping the old inode: the inode lives until the
    last mapping drops, exactly like create()'s rename-over. What this
    adds over rename-over is the DIFFERENT-GEOMETRY case: a crashed
    fleet's leftover file with another cap/B must never be attachable
    between the respawned server's create and the master's attach, and
    must never count against /dev/shm space twice.
    """
    removed = 0
    path = ShmRing._path(name)
    for p in [path] + glob.glob(path + ".new-*"):
        try:
            os.unlink(p)
            removed += 1
        except OSError:
            pass
    return removed


class ShmRing:
    """A ``[cap, B, H, W]`` uint8 observation ring backed by /dev/shm.

    ``create`` (env-server side) truncates/creates the file and maps it
    writable; ``attach`` (master side) maps it read-only. The creator is
    responsible for ``close(unlink=True)``.
    """

    def __init__(self, name: str, arr: np.ndarray, mm: mmap.mmap, f, owner: bool):
        self.name = name
        self.arr = arr
        self._mm = mm
        self._f = f
        self._owner = owner

    @staticmethod
    def _path(name: str) -> str:
        if "/" in name or name.startswith("."):
            raise ValueError(f"unsafe shm ring name {name!r}")
        return os.path.join(SHM_DIR, name)

    @classmethod
    def create(cls, name: str, cap: int, b: int, h: int, w: int) -> "ShmRing":
        path = cls._path(name)
        nbytes = cap * b * h * w
        # build under a temp name and RENAME over the final path: truncating
        # the path in place would shrink an inode a master may still have
        # mapped read-only (restart-over-stale-ring within actor_timeout),
        # and its next slot read would SIGBUS. rename is atomic, the old
        # inode lives until the master unmaps it, and the master re-attaches
        # the new inode when the restarted client's state is rebuilt.
        for stale in glob.glob(path + ".new-*"):
            try:
                os.unlink(stale)  # a creator died between open and rename
            except OSError:
                pass
        tmp = f"{path}.new-{os.getpid()}"
        f = open(tmp, "w+b")
        f.truncate(nbytes)
        mm = mmap.mmap(f.fileno(), nbytes)
        arr = np.frombuffer(mm, np.uint8).reshape(cap, b, h, w)
        os.rename(tmp, path)
        return cls(name, arr, mm, f, owner=True)

    @classmethod
    def attach(cls, name: str, cap: int, b: int, h: int, w: int) -> "ShmRing":
        path = cls._path(name)
        nbytes = cap * b * h * w
        f = open(path, "rb")
        if os.fstat(f.fileno()).st_size != nbytes:
            f.close()
            raise ValueError(
                f"shm ring {name!r} has {os.path.getsize(path)} bytes, "
                f"expected {nbytes} — header/ring shape mismatch"
            )
        mm = mmap.mmap(f.fileno(), nbytes, access=mmap.ACCESS_READ)
        arr = np.frombuffer(mm, np.uint8).reshape(cap, b, h, w)
        return cls(name, arr, mm, f, owner=False)

    def close(self, unlink: bool = False) -> None:
        """Release the mapping; ``unlink=True`` (creator) removes the file.

        numpy views handed out earlier keep the mmap's BUFFER alive via
        refcounting even after ``mmap.close()`` would fail on them — so we
        drop our references and let the last view free the mapping.
        """
        self.arr = None
        try:
            # mmap.close() raises if views are still exported; tolerate —
            # the mapping is freed when the last numpy view dies
            self._mm.close()
        except BufferError:
            pass
        try:
            self._f.close()
        except OSError:
            pass
        if unlink and self._owner:
            try:
                os.unlink(self._path(self.name))
            except OSError:
                pass
