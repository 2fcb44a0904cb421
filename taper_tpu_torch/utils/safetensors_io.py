"""safetensors interop: port of ``taper_tpu/utils/safetensors_io.py``
(``save_params``, ``load_flat``, ``load_params``).

A tree's leaves are keyed by their dotted paths (``blocks.0.attn.wq``),
the convention of PyTorch's ``state_dict`` and of the JAX package's
files, so a file written by either package loads into the other.  A
module stands for its :func:`~taper_tpu_torch.utils.checkpoint.params_tree`.
"""

from __future__ import annotations

from typing import Dict

import torch

from taper_tpu_torch.utils.checkpoint import flatten, params_tree, unflatten

__all__ = ["save_params", "load_flat", "load_params"]


def _tree(params):
    return params_tree(params) if isinstance(params, torch.nn.Module) \
        else params


def save_params(path: str, params) -> int:
    """Write a parameter tree (or a module's) as a safetensors file with
    dotted-path keys.  Returns the number of tensors written."""
    from safetensors.torch import save_file
    flat = {k: torch.as_tensor(v).detach().cpu().contiguous()
            for k, v in flatten(_tree(params), sep=".")}
    save_file(flat, path)
    return len(flat)


def load_flat(path: str) -> Dict[str, torch.Tensor]:
    """Read a safetensors file as ``{name: tensor}`` (on the CPU)."""
    from safetensors.torch import load_file
    return load_file(path)


def load_params(path: str, like):
    """Read a safetensors file back into the structure of ``like`` (a
    tree, or a module: its parameter tree) with matching dotted paths.
    The tensors keep the saved dtypes, on ``like``'s leaves' devices.
    Raises on a missing, mis-shaped or unused tensor."""
    flat = load_flat(path)
    leaves = {}
    for k, leaf in flatten(_tree(like), sep="."):
        if k not in flat:
            raise KeyError(f"missing tensor {k!r} in {path}")
        v = flat[k]
        if tuple(v.shape) != tuple(leaf.shape):
            raise ValueError(f"{k}: file shape {tuple(v.shape)}, expected "
                             f"{tuple(leaf.shape)}")
        leaves[k] = v.to(leaf.device) if torch.is_tensor(leaf) else v
    extra = set(flat) - set(leaves)
    if extra:
        raise ValueError(f"unused tensors in {path}: {sorted(extra)[:5]}")
    return unflatten(_tree(like), leaves, sep=".")
