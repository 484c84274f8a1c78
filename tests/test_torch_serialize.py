"""The port's wire codecs, shm rings and fleet deltas against the JAX
package's (``utils/serialize.py``, ``utils/shm.py``, ``telemetry/wire.py``).

The wire must stay byte-compatible: what either package's ``dumps`` /
``pack_block`` writes, the other's ``loads`` / ``unpack_block`` reads, with
CRC framing on and off, and a corrupted frame raises each package's
``CorruptFrameError``. The inputs are made from a seed with numpy.
"""

from __future__ import annotations

import numpy as np
import pytest

from distributed_ba3c_tpu.telemetry import metrics as jax_metrics
from distributed_ba3c_tpu.telemetry import wire as jax_wire
from distributed_ba3c_tpu.utils import serialize as jser
from distributed_ba3c_tpu.utils import shm as jshm
from distributed_ba3c_tpu_torch import telemetry as port_tele
from distributed_ba3c_tpu_torch.telemetry import wire as port_wire
from distributed_ba3c_tpu_torch.utils import serialize as pser
from distributed_ba3c_tpu_torch.utils import shm as pshm

CODECS = {"jax": jser, "port": pser}
PAIRS = [("jax", "port"), ("port", "jax")]


def _per_env_msg(seed: int):
    rng = np.random.default_rng(seed)
    state = rng.integers(0, 256, (84, 84, 4), dtype=np.uint8)
    return [b"cppsim-3-1", state, float(rng.normal()), bool(seed % 2),
            {"env_steps_total": 64, "reward_pos_sum": 1.5}]


def _block(seed: int):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 256, (4, 5, 84, 84), dtype=np.uint8)
    rewards = rng.normal(size=5).astype(np.float32)
    dones = (rng.random(5) < 0.3).astype(np.uint8)
    return [b"cppsim-0*block", 17, 5, {"episodes_total": 2}], [obs, rewards, dones]


def _assert_msg_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("crc", [False, True])
@pytest.mark.parametrize("src,dst", PAIRS)
def test_per_env_message_crosses_packages(src, dst, crc):
    msg = _per_env_msg(3)
    raw = CODECS[src].dumps(msg, crc=crc)
    _assert_msg_equal(CODECS[dst].loads(raw), msg)


@pytest.mark.parametrize("crc", [False, True])
def test_dumps_writes_the_jax_bytes(crc):
    msg = _per_env_msg(5)
    assert pser.dumps(msg, crc=crc) == jser.dumps(msg, crc=crc)
    assert pser.dumps(7, crc=crc) == jser.dumps(7, crc=crc)  # an action reply


@pytest.mark.parametrize("crc", [False, True])
@pytest.mark.parametrize("src,dst", PAIRS)
def test_block_message_crosses_packages(src, dst, crc):
    meta, arrays = _block(11)
    frames = [bytes(memoryview(f)) for f in CODECS[src].pack_block(meta, arrays, crc=crc)]
    got_meta, got = CODECS[dst].unpack_block(frames)
    assert got_meta == meta
    _assert_msg_equal(got, arrays)


@pytest.mark.parametrize("crc", [False, True])
def test_pack_block_writes_the_jax_frames(crc):
    meta, arrays = _block(13)
    got = [bytes(memoryview(f)) for f in pser.pack_block(meta, arrays, crc=crc)]
    want = [bytes(memoryview(f)) for f in jser.pack_block(meta, arrays, crc=crc)]
    assert got == want


def _flip(buf: bytes, at: int) -> bytes:
    b = bytearray(buf)
    b[at] ^= 0x01
    return bytes(b)


@pytest.mark.parametrize("codec", ["jax", "port"])
@pytest.mark.parametrize("src", ["jax", "port"])
def test_corrupt_per_env_frame_raises_in_both(src, codec):
    raw = CODECS[src].dumps(_per_env_msg(1), crc=True)
    with pytest.raises(CODECS[codec].CorruptFrameError):
        CODECS[codec].loads(_flip(raw, len(raw) // 2))
    with pytest.raises(CODECS[codec].CorruptFrameError):
        CODECS[codec].loads(raw[:-3])  # truncated in flight


@pytest.mark.parametrize("codec", ["jax", "port"])
@pytest.mark.parametrize("src", ["jax", "port"])
@pytest.mark.parametrize("frame", [0, 1, 3])
def test_corrupt_block_frame_raises_in_both(src, codec, frame):
    meta, arrays = _block(2)
    frames = [bytes(memoryview(f)) for f in CODECS[src].pack_block(meta, arrays, crc=True)]
    frames[frame] = _flip(frames[frame], len(frames[frame]) - 1)
    with pytest.raises(CODECS[codec].CorruptFrameError):
        CODECS[codec].unpack_block(frames)


def test_corrupt_frame_error_is_a_value_error():
    assert issubclass(pser.CorruptFrameError, ValueError)


def test_set_wire_crc_flips_the_default():
    was = pser.wire_crc_enabled()
    try:
        pser.set_wire_crc(True)
        assert pser.dumps(1)[:4] == jser.dumps(1, crc=True)[:4]
        pser.set_wire_crc(False)
        assert pser.dumps(1) == jser.dumps(1, crc=False)
    finally:
        pser.set_wire_crc(was)


# -- shm rings ----------------------------------------------------------------


@pytest.mark.parametrize("pipe,prefix", [("ipc:///tmp/x-c2s", "cppsim-0"),
                                         ("tcp://127.0.0.1:5555", "f1-cppsim-7")])
def test_ring_name_is_the_jax_name(pipe, prefix):
    assert pshm.ring_name(pipe, prefix) == jshm.ring_name(pipe, prefix)


@pytest.mark.parametrize("args", [(16, 4096, 128, 1, 5, 4), (1, 64, 0, 20, 0, 4),
                                  (64, 100, 32, 1, 5, 2, 0)])
def test_min_safe_cap_is_the_jax_formula(args):
    assert pshm.min_safe_cap(*args) == jshm.min_safe_cap(*args)


@pytest.mark.skipif(not pshm.available(), reason="no writable /dev/shm")
@pytest.mark.parametrize("creator", ["jax", "port"])
def test_a_ring_either_side_creates_the_other_attaches(creator, tmp_path):
    mods = {"jax": jshm, "port": pshm}
    name = f"ba3c-test-ring-{creator}-{tmp_path.name}"
    owner = mods[creator].ShmRing.create(name, 8, 3, 6, 5)
    reader = mods["port" if creator == "jax" else "jax"].ShmRing.attach(name, 8, 3, 6, 5)
    try:
        owner.arr[5] = np.random.default_rng(0).integers(0, 256, (3, 6, 5), dtype=np.uint8)
        np.testing.assert_array_equal(reader.arr[5], owner.arr[5])
        with pytest.raises(ValueError):
            pshm.ShmRing.attach(name, 9, 3, 6, 5)  # another geometry
    finally:
        reader.close()
        owner.close(unlink=True)
    assert pshm.reclaim_stale(name) == 0  # the creator unlinked it


# -- fleet deltas -------------------------------------------------------------


def test_delta_tracker_reports_what_the_jax_tracker_reports():
    jreg, preg = jax_metrics.Registry("simulator"), port_tele.Registry("simulator")
    jt, pt = jax_wire.DeltaTracker(jreg), port_wire.DeltaTracker(preg)
    rng = np.random.default_rng(4)
    for _ in range(5):
        for name in ("env_steps_total", "episodes_total", "reward_pos_sum"):
            v = float(rng.integers(0, 3)) * (0.5 if name == "reward_pos_sum" else 1)
            jreg.counter(name).inc(v)
            preg.counter(name).inc(v)
        assert pt.deltas() == jt.deltas()
    assert port_wire.PIGGYBACK_EVERY == jax_wire.PIGGYBACK_EVERY


def test_apply_fleet_deltas_keeps_what_the_jax_master_keeps():
    deltas = {"env_steps_total": 64, "episodes_total": 2, "bad-name": 1,
              "negative": -3, "nan": float("nan"), "flag": True, 7: 1,
              "x" * 65: 1, "reward_pos_sum": 1.5}
    jax_wire.apply_fleet_deltas(b"s0", deltas, role="fleet.ptest")
    port_wire.apply_fleet_deltas(b"s0", deltas, role="fleet.ptest")
    jax_wire.apply_fleet_deltas(b"s0", "junk", role="fleet.ptest")
    port_wire.apply_fleet_deltas(b"s0", "junk", role="fleet.ptest")
    got = port_tele.registry("fleet.ptest").scalars()
    want = jax_metrics.registry("fleet.ptest").scalars()
    assert got == want
    assert got["env_steps_total"] == 64 and "negative" not in got
