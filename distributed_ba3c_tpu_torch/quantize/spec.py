"""QuantSpec: the frozen activation-calibration document.

Port of ``distributed_ba3c_tpu/quantize/spec.py``, copied: the same
fields, the same rejections, and a ``to_json()`` and ``sha256()`` that are
byte-equal to the JAX package's, so a spec file written by either package
loads in the other and names the same calibration.

One JSON object pins everything the int8 forward needs beyond the f32
checkpoint itself: per-layer input-activation scales, the method that
produced them and how much traffic it saw. It round-trips losslessly,
rejects unknown fields (a typo'd field must fail loudly, not silently
default), and hashes stably, so a run stamped with ``quant_spec_hash``
names EXACTLY one calibration.

Standard library only: spawned env children import this module, and it
must not pull torch into them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Any, Dict, Mapping, Tuple

#: calibration statistics: ``absmax`` = running max |x| over all served
#: batches; ``percentile`` = running max of per-batch |x| percentiles
#: (clips the activation tail a stray frame would otherwise stretch the
#: whole int8 grid over)
QUANT_METHODS = ("absmax", "percentile")


class QuantSpecError(ValueError):
    """A malformed QuantSpec document (bad JSON, unknown fields, invalid
    scales). ValueError so generic callers still catch it."""


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Frozen per-layer activation scales for the int8 forward.

    ``act_scales`` maps quantized layer name (``Conv_0``..``Conv_3``,
    ``Dense_0`` for the flagship net) to the per-tensor symmetric scale
    ``s`` of that layer's INPUT: ``x_q = clip(round(x / s), -127, 127)``.
    Every scale is finite and > 0 by construction — a degenerate
    zero-range calibration freezes to scale 1.0 (calibrate.py), and this
    class re-rejects NaN/inf/non-positive on every load so a corrupt
    file cannot reach the quantized forward.
    """

    act_scales: Mapping[str, float]
    method: str = "absmax"
    percentile: float = 99.9
    calibration_batches: int = 0
    calibration_rows: int = 0
    version: int = 1

    def __post_init__(self):
        if self.version != 1:
            raise QuantSpecError(
                f"unknown quant spec version {self.version!r} (this tree "
                "speaks version 1)"
            )
        if self.method not in QUANT_METHODS:
            raise QuantSpecError(
                f"quant method must be one of {QUANT_METHODS}, got "
                f"{self.method!r}"
            )
        if not 0 < self.percentile <= 100:
            raise QuantSpecError(
                f"percentile must be in (0, 100], got {self.percentile}"
            )
        if self.calibration_batches < 0 or self.calibration_rows < 0:
            raise QuantSpecError("calibration counters must be >= 0")
        if not self.act_scales:
            raise QuantSpecError("act_scales must name at least one layer")
        clean: Dict[str, float] = {}
        for name in sorted(self.act_scales):
            s = self.act_scales[name]
            if not isinstance(name, str) or not name:
                raise QuantSpecError(
                    f"act_scales keys must be layer names, got {name!r}"
                )
            if not isinstance(s, (int, float)) or isinstance(s, bool):
                raise QuantSpecError(
                    f"act_scales[{name!r}] must be a number, got {s!r}"
                )
            s = float(s)
            if not math.isfinite(s) or s <= 0:
                raise QuantSpecError(
                    f"act_scales[{name!r}] must be finite and > 0, got {s}"
                )
            clean[name] = s
        object.__setattr__(self, "act_scales", clean)

    # -- identity ----------------------------------------------------------
    @property
    def layers(self) -> Tuple[str, ...]:
        """The quantized layer names, sorted (the forward's loop order is
        fixed by the model layout; this is the membership set)."""
        return tuple(sorted(self.act_scales))

    def sha256(self) -> str:
        """Stable content hash of the CANONICAL serialization (sorted
        keys, compact separators): two runs used the same calibration iff
        the hashes match."""
        canon = json.dumps(
            self.to_doc(), sort_keys=True, separators=(",", ":")
        )
        return hashlib.sha256(canon.encode()).hexdigest()

    # -- (de)serialization -------------------------------------------------
    def to_doc(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "method": self.method,
            "percentile": self.percentile,
            "calibration_batches": self.calibration_batches,
            "calibration_rows": self.calibration_rows,
            "act_scales": dict(self.act_scales),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_doc(), indent=2, sort_keys=True)

    @classmethod
    def from_doc(cls, doc: Any) -> "QuantSpec":
        if not isinstance(doc, Mapping):
            raise QuantSpecError(
                f"quant spec must be a JSON object, got {type(doc).__name__}"
            )
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(doc) - known)
        if unknown:
            raise QuantSpecError(f"unknown quant spec fields: {unknown}")
        if "act_scales" not in doc:
            raise QuantSpecError("quant spec missing act_scales")
        try:
            return cls(**doc)
        except QuantSpecError:
            raise
        except (TypeError, ValueError) as e:
            raise QuantSpecError(f"bad quant spec: {e}") from None

    @classmethod
    def from_json(cls, text: str) -> "QuantSpec":
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise QuantSpecError(f"quant spec is not valid JSON: {e}")
        return cls.from_doc(doc)

    @classmethod
    def load(cls, path: str) -> "QuantSpec":
        try:
            with open(path) as fh:
                text = fh.read()
        except OSError as e:
            raise QuantSpecError(f"cannot read quant spec: {e}")
        return cls.from_json(text)

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json() + "\n")
