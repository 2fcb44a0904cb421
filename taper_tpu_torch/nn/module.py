"""Module containers: port of ``taper_tpu/nn/module.py``.

The JAX package's modules are functional (``init(key)`` returns a
parameter tree, ``apply(params, x)`` is pure); the port's are
``torch.nn.Module``s that own their parameters.  Parameter names mirror
the JAX tree: :class:`Sequential` registers its children by index, as its
JAX counterpart lists their trees, and layers name their parameters ``w``
and ``b``, so a JAX tree loads by name (``utils/convert.load_jax_params``:
``1.w``, ``1.b``, ...).

Initialisation draws from an explicit ``torch.Generator`` through
``reset_parameters(generator)``, the counterpart of ``init(key)``.
"""

from __future__ import annotations

from torch import nn


class Sequential(nn.Sequential):
    """Composition of modules, applied in order (children ``0``, ``1``,
    ...).  Takes the layers as arguments or as one list, as the JAX
    ``Sequential`` does."""

    def __init__(self, *layers: nn.Module):
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)):
            layers = tuple(layers[0])
        super().__init__(*layers)

    def reset_parameters(self, generator=None) -> None:
        """Re-draw every layer's parameters, in layer order, from
        ``generator``."""
        for layer in self:
            reset = getattr(layer, "reset_parameters", None)
            if reset is not None:
                reset(generator)
