"""Quantization configuration: port of ``taper_tpu/quantization/config.py``
(the reference's ``src/quantization/config.rs``).

Types Int4 / Int8 / Float16 / BFloat16 / NF4 and the scaled fp8 formats;
schema Uniform (one scale per tensor) or PerChannel (one per output
channel, axis 0).  The same enums, constructors and range helpers as the
JAX package, so a configuration reads the same in both.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class QuantizationType(enum.Enum):
    INT4 = "int4"
    INT8 = "int8"
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"
    NF4 = "nf4"
    # absmax-scaled fp8 storage: e4m3 keeps more mantissa (weights), e5m2
    # more range (gradients, activations)
    FP8_E4M3 = "fp8_e4m3"
    FP8_E5M2 = "fp8_e5m2"


class QuantizationSchema(enum.Enum):
    UNIFORM = "uniform"          # one scale/zero-point per tensor
    PER_CHANNEL = "per_channel"  # per output-channel scales (axis 0)


_BITS = {
    QuantizationType.INT4: 4,
    QuantizationType.INT8: 8,
    QuantizationType.FLOAT16: 16,
    QuantizationType.BFLOAT16: 16,
    QuantizationType.NF4: 4,
    QuantizationType.FP8_E4M3: 8,
    QuantizationType.FP8_E5M2: 8,
}


@dataclasses.dataclass(frozen=True)
class QuantizationConfig:
    qtype: QuantizationType = QuantizationType.INT8
    schema: QuantizationSchema = QuantizationSchema.UNIFORM
    symmetric: bool = False

    @classmethod
    def int8(cls, **kw) -> "QuantizationConfig":
        return cls(QuantizationType.INT8, **kw)

    @classmethod
    def int4(cls, **kw) -> "QuantizationConfig":
        return cls(QuantizationType.INT4, **kw)

    @classmethod
    def float16(cls, **kw) -> "QuantizationConfig":
        return cls(QuantizationType.FLOAT16, **kw)

    @classmethod
    def bfloat16(cls, **kw) -> "QuantizationConfig":
        return cls(QuantizationType.BFLOAT16, **kw)

    @classmethod
    def nf4(cls, **kw) -> "QuantizationConfig":
        return cls(QuantizationType.NF4, **kw)

    @classmethod
    def fp8_e4m3(cls, **kw) -> "QuantizationConfig":
        return cls(QuantizationType.FP8_E4M3, **kw)

    @classmethod
    def fp8_e5m2(cls, **kw) -> "QuantizationConfig":
        return cls(QuantizationType.FP8_E5M2, **kw)

    def compute_range(self) -> Optional[Tuple[int, int]]:
        """(qmin, qmax) for integer types, None for float formats."""
        if self.qtype == QuantizationType.INT8:
            return (-128, 127)
        if self.qtype == QuantizationType.INT4:
            return (-8, 7)
        return None

    def bit_width(self) -> int:
        return _BITS[self.qtype]

    @staticmethod
    def compute_scale(min_val: float, max_val: float, qmin: int,
                      qmax: int) -> float:
        return (max_val - min_val) / (qmax - qmin)

    @staticmethod
    def compute_zero_point(min_val: float, scale: float, qmin: int) -> int:
        if scale == 0.0:
            return 0
        return int(round(qmin - min_val / scale))
