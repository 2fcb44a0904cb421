"""Post-training quantization: port of ``taper_tpu/quantization/ptq.py``
(the reference's ``Module::quantize``, ``src/nn.rs:62-69, 336-345``;
example ``examples/ptq_quantize.rs``).

The JAX package maps a parameter tree to one whose weight leaves are
``QuantizedTensor``s.  The port's modules own their parameters, so
:func:`quantize_params` returns a quantized **copy** of a trained
``nn.Module`` in which each qualifying ``nn.Parameter`` is replaced by a
:class:`~taper_tpu_torch.quantization.qtensor.QuantizedTensor` of the same
name; the original is left untouched.  The layers take such a weight in
place of the parameter: int8 and int4 ``Linear`` weights reach the
dequant-on-load kernels (``ops/quant.py``), every other format and layer
dequantizes on the fly.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from taper_tpu_torch.quantization.config import QuantizationConfig
from taper_tpu_torch.quantization.qtensor import QuantizedTensor, quantize

# Leaves bigger than this get quantized; small biases stay f32 (quantizing
# a 10-element bias saves nothing and costs accuracy)
_MIN_QUANT_SIZE = 64


def replace_leaf(module: nn.Module, name: str, value) -> None:
    """Install ``value`` (a QuantizedTensor or an nn.Parameter) under
    ``name`` in ``module``, in place of whatever was there."""
    delattr(module, name)
    setattr(module, name, value)


def quantize_params(model: nn.Module, config: QuantizationConfig,
                    min_size: int = _MIN_QUANT_SIZE) -> nn.Module:
    """A copy of ``model`` whose floating-point parameters with ndim >= 2
    and at least ``min_size`` elements are quantized (the JAX rule)."""
    model = copy.deepcopy(model)
    for module in list(model.modules()):
        for name, p in list(module.named_parameters(recurse=False)):
            if (p.dim() >= 2 and p.numel() >= min_size
                    and p.is_floating_point()):
                replace_leaf(module, name, quantize(p, config))
    return model


def dequantize_params(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with every QuantizedTensor dequantized back to an
    f32 ``nn.Parameter`` (the inverse of :func:`quantize_params`)."""
    model = copy.deepcopy(model)
    for module in list(model.modules()):
        for name, child in list(module.named_children()):
            if isinstance(child, QuantizedTensor):
                replace_leaf(module, name, nn.Parameter(child.dequantize()))
    return model


def quantized_bytes(model: nn.Module) -> int:
    """Bytes of what the JAX package's parameter tree would hold: every
    parameter, every QuantizedTensor's storage, and BatchNorm's
    ``running_*`` buffers (leaves of JAX's tree)."""
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    for name, module in model.named_modules():
        if isinstance(module, QuantizedTensor):
            total += module.nbytes()
    for name, buf in model.named_buffers():
        if name.rsplit(".", 1)[-1].startswith("running_"):
            total += buf.numel() * buf.element_size()
    return total


class QuantizedModel(nn.Module):
    """Inference wrapper around a quantized copy (the reference's
    ``QuantizedSequential``, ``nn.rs:160-177``): ``forward`` runs the
    copy in eval mode without gradients.  Quantized weights flow straight
    into the layer ops, with no dequantized cache to go stale."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module.eval()

    def forward(self, *args, **kwargs):
        with torch.no_grad():
            return self.module(*args, **kwargs)


def quantize_model(model: nn.Module,
                   config: QuantizationConfig) -> QuantizedModel:
    """One-call PTQ, the analogue of the reference's
    ``model.quantize(&config)``: a :class:`QuantizedModel` over a quantized
    copy of ``model``."""
    return QuantizedModel(quantize_params(model, config))
