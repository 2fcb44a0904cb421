"""Move parameters from the JAX package into the port.

The port's modules name their parameters after the JAX parameter tree
(``tok.w``, ``pos.w``, ``blocks[i].{ln1, attn, ln2, mlp}``, ``ln_f`` and,
untied, ``head``), and both packages keep weights as ``[out, in]``, so a
tree converts leaf by leaf under its dotted path.  An MoE block's FFN
keeps JAX's stacked leaves: ``mlp.gate [n, dim]`` and
``mlp.experts.{w1 [n, hidden, dim], b1, w2 [n, dim, hidden], b2}``.  BatchNorm's
``running_*`` leaves land in the buffers of the same names.

A PTQ tree (``taper_tpu.quantization.ptq.quantize_params``) loads too: a
leaf that carries ``values``, ``scale``, ``zero_point``, ``qtype.name``,
``schema.name`` and ``shape`` is a quantized tensor (recognised by those
attributes; the port imports nothing of the JAX package), and lands as the
port's ``QuantizedTensor`` in place of the parameter of that name, with
the codes bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from taper_tpu_torch.quantization.config import (
    QuantizationSchema, QuantizationType)
from taper_tpu_torch.quantization.ptq import replace_leaf
from taper_tpu_torch.quantization.qtensor import QuantizedTensor

_QT_FIELDS = ("values", "scale", "zero_point", "qtype", "schema", "shape")
# numpy dtypes (ml_dtypes' among them) that torch.from_numpy cannot take,
# by name: the integer view to read them through and the torch dtype
_VIEWS = {"bfloat16": (np.int16, torch.bfloat16),
          "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
          "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def _is_qtensor(leaf) -> bool:
    return all(hasattr(leaf, f) for f in _QT_FIELDS)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _targets(model: torch.nn.Module) -> dict:
    """The port's tensors a JAX tree fills: every parameter, every
    QuantizedTensor, and every buffer named ``running_*`` (BatchNorm's
    statistics, which the JAX package keeps in the parameter tree under
    those names)."""
    out = dict(model.named_parameters())
    out.update((k, m) for k, m in model.named_modules()
               if isinstance(m, QuantizedTensor))
    out.update((k, b) for k, b in model.named_buffers()
               if k.rsplit(".", 1)[-1].startswith("running_"))
    return out


def _tensor(array) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype, bit for bit."""
    a = np.asarray(array)
    view = _VIEWS.get(a.dtype.name)
    if view is None:
        return torch.from_numpy(np.array(a))
    return torch.from_numpy(np.array(a.view(view[0]))).view(view[1])


def _qtensor(leaf, device) -> QuantizedTensor:
    """The port's QuantizedTensor of a JAX quantized tensor."""
    return QuantizedTensor(
        _tensor(leaf.values), _tensor(leaf.scale),
        _tensor(leaf.zero_point), QuantizationType[leaf.qtype.name],
        QuantizationSchema[leaf.schema.name], tuple(leaf.shape)).to(device)


def load_jax_params(model: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy a JAX parameter tree (nested dicts/lists of numpy arrays, as
    ``TinyGPT.init`` or any layer's ``init`` returns, passed through
    ``np.asarray``, or a PTQ tree whose quantized leaves are JAX's
    ``QuantizedTensor``s) into ``model``, in place.  A plain leaf keeps the
    dtype and device of the tensor it lands in; a quantized leaf replaces
    the parameter of its name with a ``QuantizedTensor`` on that device.
    Raises on a missing, extra or mis-shaped leaf."""
    leaves = dict(_flatten(tree))
    targets = _targets(model)
    if leaves.keys() != targets.keys():
        raise KeyError(f"parameter trees differ: only in JAX "
                       f"{sorted(leaves.keys() - targets.keys())}, only in "
                       f"the port {sorted(targets.keys() - leaves.keys())}")
    with torch.no_grad():
        for name, t in targets.items():
            leaf = leaves[name]
            shape = (tuple(leaf.shape) if _is_qtensor(leaf)
                     else np.shape(leaf))
            if tuple(shape) != tuple(t.shape):
                raise ValueError(f"{name}: JAX shape {shape}, port shape "
                                 f"{tuple(t.shape)}")
            owner, _, attr = name.rpartition(".")
            module = model.get_submodule(owner)
            device = t.device
            if _is_qtensor(leaf):
                replace_leaf(module, attr, _qtensor(leaf, device))
            elif isinstance(t, QuantizedTensor):
                replace_leaf(module, attr, nn.Parameter(
                    torch.from_numpy(np.array(leaf, np.float32)).to(
                        device)))
            else:
                t.copy_(torch.from_numpy(
                    np.asarray(leaf).astype(np.float32)))
    return model
