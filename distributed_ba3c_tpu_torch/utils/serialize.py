"""msgpack serialization with zero-copy numpy support.

A copy of ``distributed_ba3c_tpu/utils/serialize.py``. The wire is
byte-compatible with the JAX package's: a JAX env server feeds the port's
master and the reverse (``tests/test_torch_serialize.py``).

Reference equivalent: ``tensorpack/utils/serialize.py`` — msgpack +
msgpack_numpy ``dumps``/``loads`` used for every ZMQ payload (SURVEY.md §2.8
#25, §2.12). msgpack_numpy is not installed here, so ndarrays are encoded as a
msgpack ext type carrying (dtype, shape, raw bytes); uint8 frames therefore
cross the wire at 1 byte/pixel with no base64/pickle overhead, matching the
reference's design intent.

Two codecs live here:

- :func:`dumps` / :func:`loads` — ONE msgpack byte string per message (the
  per-env wire). ``dumps`` copies every array once (``tobytes``); fine for
  one 28 KB state per message, ruinous for a whole [B, ...] block.
- :func:`pack_block` / :func:`unpack_block` — a MULTIPART message: one tiny
  msgpack header frame describing metadata + array specs, then each array's
  raw buffer as its own frame. The pack side hands zmq the arrays' own
  memory (no ``tobytes``), the unpack side returns ``np.frombuffer`` views
  over the received frames (no copy). This is the block wire's codec
  (docs/actor_plane.md).

**Integrity framing (docs/netchaos.md):** both codecs optionally carry
CRC32s so a corrupted-in-flight frame becomes a typed
:class:`CorruptFrameError` at the receiver instead of a silently wrong
array (a bit-flipped obs buffer reshapes fine and poisons training with
zero signal; a truncated one must never reach ``frombuffer``). The block
header grows a third element — per-frame CRCs — and single-frame
messages get a 4-byte magic + CRC prefix; both are length/prefix
versioned, so CRC-off senders parse unchanged at CRC-aware receivers.
Enable fleet-wide with ``BA3C_WIRE_CRC=1`` (cli ``--wire_crc``), or per
call with ``crc=True``. ``CorruptFrameError`` subclasses ``ValueError``
so every pre-existing untrusted-wire handler already contains it; the
receive loops additionally count it as its own typed reject
(``corrupt_frames_total``).
"""

from __future__ import annotations

import binascii
import os
import struct
from typing import Any, List, Optional, Sequence, Tuple

import msgpack
import numpy as np

_NDARRAY_EXT = 42

#: prefix of a CRC-framed single-frame message: 3 magic bytes + version,
#: then the little-endian CRC32 of the payload, then the payload. No
#: legitimate ``dumps`` output starts with 0xBA (our top level is always a
#: msgpack array/map), so prefix detection cannot misfire on old senders.
_CRC_MAGIC = b"\xba\x3c\xc3\x01"


class CorruptFrameError(ValueError):
    """A frame failed its CRC32 (or CRC framing was structurally broken).

    Subclasses ValueError on purpose: every receive loop that already
    drops undecodable wire input keeps working; loops that care count it
    separately as the typed ``corrupt_frame`` reject (docs/netchaos.md).
    """


_wire_crc = os.environ.get("BA3C_WIRE_CRC", "0").lower() not in (
    "0", "", "false",
)


def wire_crc_enabled() -> bool:
    """Process-wide CRC default (``BA3C_WIRE_CRC=1`` / :func:`set_wire_crc`);
    the per-call ``crc=`` argument overrides it."""
    return _wire_crc


def set_wire_crc(flag: bool) -> None:
    """Flip the process-wide CRC default (cli.py's ``--wire_crc``; exported
    as BA3C_WIRE_CRC for child processes so a whole fleet agrees)."""
    global _wire_crc
    _wire_crc = bool(flag)


def _crc(buf) -> int:
    return binascii.crc32(buf) & 0xFFFFFFFF


def _default(obj: Any):
    if isinstance(obj, np.ndarray):
        if not obj.flags["C_CONTIGUOUS"]:
            obj = np.ascontiguousarray(obj)
        header = msgpack.packb((obj.dtype.str, obj.shape), use_bin_type=True)
        return msgpack.ExtType(_NDARRAY_EXT, header + obj.tobytes())
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    raise TypeError(f"cannot serialize {type(obj)}")


def _ext_hook(code: int, data: bytes):
    if code != _NDARRAY_EXT:
        return msgpack.ExtType(code, data)
    unpacker = msgpack.Unpacker(use_list=False, raw=False)
    unpacker.feed(data)
    dtype_str, shape = unpacker.unpack()
    offset = unpacker.tell()
    arr = np.frombuffer(data, dtype=np.dtype(dtype_str), offset=offset)
    return arr.reshape(shape)


def dumps(obj: Any, crc: Optional[bool] = None) -> bytes:
    """Serialize to msgpack bytes (ndarray-aware).

    ``crc`` (None = the :func:`wire_crc_enabled` process default) prefixes
    the payload with ``_CRC_MAGIC + crc32`` so the receiving :func:`loads`
    verifies integrity before any array view is built.
    """
    payload = msgpack.packb(obj, use_bin_type=True, default=_default)
    if wire_crc_enabled() if crc is None else crc:
        return _CRC_MAGIC + struct.pack("<I", _crc(payload)) + payload
    return payload


def loads(buf) -> Any:
    """Inverse of :func:`dumps`. Arrays are views over the input buffer.

    Accepts any bytes-like object (``bytes``, ``memoryview``, ``zmq.Frame``
    buffers) so non-copying ZMQ receives decode without a round-trip through
    ``bytes()``. CRC-framed payloads (prefix-detected) are verified first:
    a mismatch — corruption OR truncation in flight — raises the typed
    :class:`CorruptFrameError` instead of handing back a wrong object.
    """
    view = memoryview(buf)
    if len(view) >= 8 and bytes(view[:4]) == _CRC_MAGIC:
        (want,) = struct.unpack("<I", view[4:8])
        payload = view[8:]
        if _crc(payload) != want:
            raise CorruptFrameError(
                f"single-frame payload failed CRC32 ({len(payload)} bytes)"
            )
        return msgpack.unpackb(payload, raw=False, ext_hook=_ext_hook)
    return msgpack.unpackb(view, raw=False, ext_hook=_ext_hook)


def pack_block(
    meta: Any, arrays: Sequence[np.ndarray], crc: Optional[bool] = None
) -> List[Any]:
    """Multipart zero-copy encode: ``[header, raw_buf_0, ..., raw_buf_n]``.

    ``meta`` is any msgpack-serializable object (the block wire puts the
    sender ident + step counter here). Each array contributes one frame that
    IS its buffer — no ``tobytes`` copy; non-contiguous inputs are made
    contiguous first (the one copy this path ever does, and only when the
    caller hands a strided view). The caller must not mutate the arrays
    until the message is known to have left the process — the block wire's
    lockstep send→await-actions structure guarantees exactly that.

    ``crc`` (None = the process default) appends a third, length-versioned
    header element: per-frame CRC32s, covering the header's own bytes-to-be
    indirectly through msgpack structure and every payload frame exactly.
    Still zero-copy — the CRC is one read-only pass over buffers zmq is
    about to read anyway.
    """
    use_crc = wire_crc_enabled() if crc is None else crc
    specs: List[Tuple[str, Tuple[int, ...]]] = []
    frames: List[Any] = [b""]  # placeholder for the header
    crcs: List[int] = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        specs.append((a.dtype.str, a.shape))
        frames.append(a.data)
        if use_crc:
            crcs.append(_crc(a.data))
    header: Tuple = (meta, specs, crcs) if use_crc else (meta, specs)
    packed = msgpack.packb(header, use_bin_type=True, default=_default)
    if use_crc:
        # the header frame carries its OWN prefix CRC too: a flipped bit
        # in meta/specs would otherwise mis-route or mis-shape silently —
        # the payload CRCs cannot vouch for the frame that declares them
        packed = _CRC_MAGIC + struct.pack("<I", _crc(packed)) + packed
    frames[0] = packed
    return frames


def unpack_block(frames: Sequence[Any]) -> Tuple[Any, List[np.ndarray]]:
    """Inverse of :func:`pack_block`: ``(meta, arrays)``.

    ``frames`` are bytes-like (bytes, memoryview, or ``zmq.Frame.buffer``).
    Every returned array is a ``frombuffer`` VIEW over its frame — zero
    copies; the arrays keep the frames alive for as long as they are
    referenced.

    A 3-element header carries per-frame CRC32s (length-versioned: the
    2-element form parses exactly as before): every payload frame is
    verified BEFORE any ``frombuffer`` view is built, and a mismatch
    raises the typed :class:`CorruptFrameError` — a truncated or
    bit-flipped frame must never become an array.
    """
    hview = memoryview(frames[0])
    if len(hview) >= 8 and bytes(hview[:4]) == _CRC_MAGIC:
        (want,) = struct.unpack("<I", hview[4:8])
        hview = hview[8:]
        if _crc(hview) != want:
            raise CorruptFrameError(
                f"block header failed CRC32 ({len(hview)} bytes)"
            )
    header = msgpack.unpackb(hview, raw=False, ext_hook=_ext_hook)
    if not isinstance(header, (tuple, list)) or len(header) not in (2, 3):
        raise ValueError(
            f"block header is not a (meta, specs[, crcs]) tuple: "
            f"{type(header).__name__}/{len(header) if isinstance(header, (tuple, list)) else '?'}"
        )
    meta, specs = header[0], header[1]
    crcs = header[2] if len(header) == 3 else None
    if len(specs) != len(frames) - 1:
        raise ValueError(
            f"block header declares {len(specs)} arrays but the message "
            f"carries {len(frames) - 1} payload frames"
        )
    if crcs is not None:
        if len(crcs) != len(frames) - 1:
            raise CorruptFrameError(
                f"block header carries {len(crcs)} CRCs for "
                f"{len(frames) - 1} payload frames"
            )
        for i, (want, buf) in enumerate(zip(crcs, frames[1:])):
            if _crc(buf) != want:
                raise CorruptFrameError(
                    f"block payload frame {i} failed CRC32 "
                    f"({len(memoryview(buf))} bytes on the wire)"
                )
    arrays = [
        np.frombuffer(buf, dtype=np.dtype(dtype_str)).reshape(shape)
        for (dtype_str, shape), buf in zip(specs, frames[1:])
    ]
    return meta, arrays
