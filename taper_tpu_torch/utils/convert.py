"""Move parameters from the JAX package into the port.

The port's modules name their parameters after the JAX parameter tree
(``tok.w``, ``pos.w``, ``blocks[i].{ln1, attn, ln2, mlp}``, ``ln_f`` and,
untied, ``head``), and both packages keep weights as ``[out, in]``, so a
tree converts leaf by leaf under its dotted path.  BatchNorm's
``running_*`` leaves land in the buffers of the same names.
"""

from __future__ import annotations

import numpy as np
import torch


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
    """The port's tensors a JAX tree fills: every parameter, and every
    buffer named ``running_*`` (BatchNorm's statistics, which the JAX
    package keeps in the parameter tree under those names)."""
    out = dict(model.named_parameters())
    out.update((k, b) for k, b in model.named_buffers()
               if k.rsplit(".", 1)[-1].startswith("running_"))
    return out


def load_jax_params(model: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy a JAX parameter tree (nested dicts/lists of numpy arrays, as
    ``TinyGPT.init`` or any layer's ``init`` returns, passed through
    ``np.asarray``) into ``model``'s parameters and ``running_*`` buffers,
    in place.  Each leaf keeps the dtype and device of the tensor it lands
    in.  Raises on a missing, extra or mis-shaped leaf."""
    leaves = dict(_flatten(tree))
    targets = _targets(model)
    if leaves.keys() != targets.keys():
        raise KeyError(f"parameter trees differ: only in JAX "
                       f"{sorted(leaves.keys() - targets.keys())}, only in "
                       f"the port {sorted(targets.keys() - leaves.keys())}")
    with torch.no_grad():
        for name, t in targets.items():
            value = np.asarray(leaves[name])
            if tuple(value.shape) != tuple(t.shape):
                raise ValueError(f"{name}: JAX shape {value.shape}, port "
                                 f"shape {tuple(t.shape)}")
            t.copy_(torch.from_numpy(value.astype(np.float32)))
    return model
