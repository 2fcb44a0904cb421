"""Quantized tensors: int8 / int4 / fp16 / bf16 / fp8 / NF4 encode and
decode, port of ``taper_tpu/quantization/qtensor.py``.

* int8: affine ``(scale, zero_point)``, per tensor or per output channel,
  the reference's min/max -> scale/zero-point math;
* int4: the same math over ``[-8, 7]``, two nibbles a byte in the flat
  row-major order, the even element in the low nibble (``_pack_nibbles``);
* fp16 / bf16: the native dtypes;
* fp8 e4m3 / e5m2: absmax-scaled so the tensor's range fills the format
  (``torch.float8_e4m3fn`` / ``torch.float8_e5m2``);
* NF4: the 16-level NormalFloat codebook with a per-block absmax scale.

Codes, scales and zero points equal the JAX package's bit for bit: the
same f32 operations in the same order, rounding half to even, and
``x / scale`` as a division, not a multiply by a reciprocal.

:class:`QuantizedTensor` is a small ``nn.Module`` that holds ``values``,
``scale`` and ``zero_point`` as buffers and ``qtype``, ``schema`` and
``shape`` as attributes.  Where the JAX package makes it a pytree leaf of
the parameter tree, the port installs it in place of the ``nn.Parameter``
of the same name (``ptq.quantize_params``), so ``blk.attn.wq`` is a
``QuantizedTensor``; it moves with ``model.to(device)``.  Its storage
dtypes are the format itself, so ``model.to(dtype)``, ``.half()`` and the
like move it between devices and never cast it.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from taper_tpu_torch.quantization.config import (
    QuantizationConfig, QuantizationSchema, QuantizationType)

# NormalFloat4 codebook: 16 quantiles of N(0, 1) normalised to [-1, 1]
NF4_CODE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)
NF4_BLOCK = 64

_FP8 = {QuantizationType.FP8_E4M3: torch.float8_e4m3fn,
        QuantizationType.FP8_E5M2: torch.float8_e5m2}
_HALF = {QuantizationType.FLOAT16: torch.float16,
         QuantizationType.BFLOAT16: torch.bfloat16}


class QuantizedTensor(nn.Module):
    """Quantized storage of one weight of shape ``shape``: ``values``
    (int8 codes, packed uint8 nibbles, fp16/bf16/fp8), ``scale`` (per
    tensor, per channel or per NF4 block) and ``zero_point`` (int32,
    integer types only; 0 elsewhere)."""

    def __init__(self, values, scale, zero_point, qtype: QuantizationType,
                 schema: QuantizationSchema, shape: Tuple[int, ...]):
        super().__init__()
        self.register_buffer("values", values)
        self.register_buffer("scale", scale)
        self.register_buffer("zero_point", zero_point)
        self.qtype = qtype
        self.schema = schema
        self.shape = tuple(int(d) for d in shape)

    def _apply(self, fn, recurse=True):
        # moves only: ask fn where an empty tensor goes, keep each dtype
        for name, buf in self._buffers.items():
            device = fn(buf.new_empty(0)).device
            self._buffers[name] = buf.to(device)
        return self

    @property
    def per_channel(self) -> bool:
        return self.schema == QuantizationSchema.PER_CHANNEL

    @property
    def device(self) -> torch.device:
        return self.values.device

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.values, self.scale, self.zero_point))

    def compression_ratio(self) -> float:
        n = 1
        for d in self.shape:
            n *= d
        return n * 4 / max(self.nbytes(), 1)

    def dequantize(self) -> torch.Tensor:
        return dequantize(self)

    def extra_repr(self) -> str:
        return (f"{self.qtype.value}, {self.schema.value}, "
                f"shape={self.shape}")


def _minmax(x, per_channel: bool):
    if per_channel:
        flat = x.reshape(x.shape[0], -1)
        return flat.amin(1), flat.amax(1)
    return x.min(), x.max()


def _expand(v, x, per_channel: bool):
    if per_channel:
        return v.reshape((-1,) + (1,) * (x.dim() - 1))
    return v


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (int8 in [-8, 7], or uint4 codes) pairwise over the
    flat order: element 2i in the low nibble of byte i, 2i+1 in the high."""
    flat = q.reshape(-1).to(torch.uint8) & 0xF
    if flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    return (flat[1::2] << 4) | flat[0::2]


def unpack_nibbles(packed: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` uint4 codes of ``packed``, in the flat order."""
    return torch.stack([packed & 0xF, packed >> 4], dim=1).reshape(-1)[:n]


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` for a Python number ``b``, rounded as one division on
    every device: PyTorch's CUDA kernel multiplies by the reciprocal of a
    CPU scalar divisor, which can differ from JAX's quotient in the last
    bit, so ``b`` goes in as a tensor on ``a``'s device."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def _scalar(value, dtype, device):
    return torch.tensor(value, dtype=dtype, device=device)


def quantize(x: torch.Tensor, config: QuantizationConfig) -> QuantizedTensor:
    """f32 tensor -> :class:`QuantizedTensor` on ``x``'s device (reference
    ``Tensor::quantize``, ``tensor.rs:2084-2107``)."""
    x = x.detach().float()
    per_ch = config.schema == QuantizationSchema.PER_CHANNEL
    qt, dev = config.qtype, x.device

    if qt in _HALF:
        return QuantizedTensor(x.to(_HALF[qt]),
                               _scalar(1.0, torch.float32, dev),
                               _scalar(0, torch.int32, dev), qt,
                               config.schema, x.shape)

    if qt in _FP8:
        dtype = _FP8[qt]
        fmax = float(torch.finfo(dtype).max)     # e4m3 448, e5m2 57344
        mn, mx = _minmax(x, per_ch)
        amax = torch.maximum(mn.abs(), mx.abs()).clamp_min(1e-12)
        scale = true_div(amax, fmax)
        q = (x / _expand(scale, x, per_ch)).to(dtype)
        return QuantizedTensor(q, scale, _scalar(0, torch.int32, dev), qt,
                               config.schema, x.shape)

    if qt in (QuantizationType.INT8, QuantizationType.INT4):
        qmin, qmax = config.compute_range()
        mn, mx = _minmax(x, per_ch)
        if config.symmetric:
            amax = torch.maximum(mn.abs(), mx.abs())
            scale = true_div(amax, qmax).clamp_min(1e-12)
            zp = torch.zeros_like(scale, dtype=torch.int32)
        else:
            scale = true_div(mx - mn, qmax - qmin).clamp_min(1e-12)
            zp = torch.round(qmin - mn / scale).to(torch.int32)
        q = torch.clamp(torch.round(x / _expand(scale, x, per_ch))
                        + _expand(zp, x, per_ch), qmin, qmax).to(torch.int8)
        if qt == QuantizationType.INT4:
            q = pack_nibbles(q)
        return QuantizedTensor(q, scale, zp, qt, config.schema, x.shape)

    if qt == QuantizationType.NF4:
        flat = x.reshape(-1)
        n = flat.numel()
        nb = -(-n // NF4_BLOCK)
        flat = torch.nn.functional.pad(flat, (0, nb * NF4_BLOCK - n))
        flat = flat.reshape(nb, NF4_BLOCK)
        absmax = flat.abs().amax(1, keepdim=True).clamp_min(1e-12)
        normed = flat / absmax
        code = torch.tensor(NF4_CODE, dtype=torch.float32, device=dev)
        # nearest codebook entry per element (the first on a tie)
        idx = (normed[..., None] - code).abs().argmin(-1).to(torch.uint8)
        return QuantizedTensor(pack_nibbles(idx), absmax[:, 0],
                               _scalar(0, torch.int32, dev), qt,
                               config.schema, x.shape)

    raise ValueError(f"unsupported qtype {qt}")


def unpack_int4(packed: torch.Tensor, shape) -> torch.Tensor:
    """The signed int4 codes of flat packed nibbles, ``[*shape]`` int32
    (two's complement: a code above 7 is itself minus 16)."""
    n = 1
    for d in shape:
        n *= d
    codes = unpack_nibbles(packed.reshape(-1), n).to(torch.int32)
    return torch.where(codes > 7, codes - 16, codes).reshape(shape)


def dense(t):
    """``t`` as a plain tensor: a :class:`QuantizedTensor` dequantized,
    anything else (a tensor, ``None``) as it is."""
    return t.dequantize() if isinstance(t, QuantizedTensor) else t


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    """:class:`QuantizedTensor` -> f32 (``tensor.rs:318-374``, with the
    reference's stubs made real)."""
    t = qt.qtype
    if t in _HALF:
        return qt.values.float()

    if t in _FP8:
        v = qt.values.float()
        return v * _expand(qt.scale, v, qt.per_channel)

    if t in (QuantizationType.INT8, QuantizationType.INT4):
        q = (qt.values if t == QuantizationType.INT8
             else unpack_int4(qt.values, qt.shape)).float()
        scale = _expand(qt.scale, q, qt.per_channel)
        zp = _expand(qt.zero_point.float(), q, qt.per_channel)
        return (q - zp) * scale

    if t == QuantizationType.NF4:
        n = 1
        for d in qt.shape:
            n *= d
        idx = unpack_nibbles(qt.values, -(-n // NF4_BLOCK) * NF4_BLOCK)
        code = torch.tensor(NF4_CODE, dtype=torch.float32, device=qt.device)
        vals = code[idx.long()].reshape(-1, NF4_BLOCK) * qt.scale[:, None]
        return vals.reshape(-1)[:n].reshape(qt.shape)

    raise ValueError(f"unsupported qtype {t}")
