"""Checkpoint save and load: port of ``taper_tpu/utils/checkpoint.py``
(the unsharded part: ``save_checkpoint``, ``load_checkpoint``,
``CheckpointManager``).

The format is the JAX package's: one ``.npz`` holding every leaf of a tree
under ``leaf::<path>`` and metadata scalars under ``meta::<key>``, where
``<path>`` joins the tree's keys and list indices with ``/``, written to a
temporary name and renamed into place.  A tree is nested dicts, lists and
tuples whose leaves are tensors, numpy arrays or numbers.
:func:`params_tree` gives a module's tree under the JAX parameter tree's
names (``tok/w``, ``blocks/0/attn/wq``, ...: the port's modules mirror
them, ``utils/convert.py``), so a parameter file written by either package
loads into the other.

Not ported yet: the sharded forms (``shardings=``,
``save_checkpoint_sharded``/``load_checkpoint_sharded``), which wait for
the port's meshes.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from taper_tpu_torch.quantization.qtensor import QuantizedTensor
from taper_tpu_torch.utils import not_ported


def flatten(tree, sep="/", prefix=""):
    """``(path, leaf)`` pairs of a tree, the path's parts joined by
    ``sep``, dict keys in sorted order as JAX's ``tree_flatten`` visits
    them."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from flatten(tree[key], sep, f"{prefix}{key}{sep}")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from flatten(sub, sep, f"{prefix}{i}{sep}")
    else:
        yield prefix[:-len(sep)], tree


def unflatten(tree, leaves, sep="/"):
    """A tree of ``tree``'s structure with the leaves of ``leaves``
    (``{path: leaf}``, paths joined by ``sep``)."""
    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(node[k], f"{prefix}{k}{sep}") for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub, f"{prefix}{i}{sep}")
                              for i, sub in enumerate(node))
        return leaves[prefix[:-len(sep)]]
    return build(tree, "")


def tree_map(fn, *trees):
    """A tree of ``trees[0]``'s structure whose leaves are ``fn`` of the
    leaves at the same path of each tree."""
    leaves = [dict(flatten(t)) for t in trees]
    return unflatten(trees[0], {p: fn(*(lv[p] for lv in leaves))
                                for p in leaves[0]})


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a copy: later in-place updates of
    the tensor do not reach it)."""
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf)


def nest(flat: Dict[str, Any]) -> dict:
    """Nested dicts of a ``{"a.b.c": leaf}`` mapping (dotted module
    names, as ``named_parameters`` gives them)."""
    out: dict = {}
    for name, leaf in flat.items():
        node = out
        *parents, last = name.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def params_tree(model: torch.nn.Module) -> dict:
    """``model``'s parameters and BatchNorm ``running_*`` buffers (the
    tensors themselves) as nested dicts under the JAX parameter tree's
    names.  A PTQ'd model's quantized leaves are not ported here."""
    not_ported("params_tree", quantized_leaves=any(
        isinstance(m, QuantizedTensor) for m in model.modules()))
    flat = dict(model.named_parameters())
    flat.update((k, b) for k, b in model.named_buffers()
                if k.rsplit(".", 1)[-1].startswith("running_"))
    return nest(flat)


def save_checkpoint(path: str, tree: Any,
                    metadata: Optional[Dict[str, float]] = None) -> None:
    """Serialise a tree of arrays to ``path`` (.npz), atomically."""
    payload = {f"leaf::{p}": _host(v) for p, v in flatten(tree)}
    for k, v in (metadata or {}).items():
        payload[f"meta::{k}"] = np.asarray(v)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, template: Any, shardings: Any = None):
    """Restore a tree with the structure of ``template`` from ``path``.

    Returns ``(tree, metadata)``.  Every leaf of the template must be in
    the file with the same shape; each comes back in the template leaf's
    dtype, as a tensor on its device where the template leaf is a tensor,
    else as a numpy array.  ``shardings`` is not ported."""
    not_ported("load_checkpoint", shardings=shardings is not None)
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files}
    leaves = {}
    for p, tmpl in flatten(template):
        key = f"leaf::{p}"
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = stored[key]
        shape = tuple(tmpl.shape) if torch.is_tensor(tmpl) \
            else np.shape(tmpl)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{arr.shape} vs template {shape}")
        if torch.is_tensor(tmpl):
            leaves[p] = torch.from_numpy(np.array(arr)).to(
                device=tmpl.device, dtype=tmpl.dtype)
        else:
            leaves[p] = arr.astype(np.asarray(tmpl).dtype)
    metadata = {k[len("meta::"):]: stored[k].item()
                for k in stored if k.startswith("meta::")}
    return unflatten(template, leaves), metadata


def copy_tree_(dst: Any, src: Any) -> None:
    """Copy every tensor leaf of ``src`` into the tensor at the same path
    of ``dst``, in place (a loaded tree into a model's own tensors)."""
    with torch.no_grad():
        leaves = dict(flatten(src))
        for p, t in flatten(dst):
            t.copy_(leaves[p])


class CheckpointManager:
    """Rotating checkpoint directory with a retention policy and an
    asynchronous save.

    * ``save(step, tree)`` writes ``ckpt_<step>.npz`` (atomic rename);
    * keeps the newest ``max_to_keep`` steps, plus the ``keep_best`` steps
      by ``metric`` (``mode='min'`` for losses, ``'max'`` for
      accuracies), so a best-validation checkpoint survives rotation;
    * ``async_save=True`` copies the tree to host memory on the caller's
      thread (so later in-place updates cannot reach the file) and writes
      it on a background thread; ``wait()`` joins it and raises what it
      raised;
    * ``restore(template, step=None)`` loads the given (default: latest)
      step.

    A ``manifest.json`` in the directory records step -> (file, metric)
    and is rewritten atomically after every save and rotation, so a killed
    run resumes from whatever the manifest last committed."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 keep_best: int = 0, mode: str = "min",
                 async_save: bool = False):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.keep_best = keep_best
        self.mode = mode
        self.async_save = async_save
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None
        self._pending_error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)
        self._manifest: Dict[str, Dict] = self._read_manifest()

    # -- manifest ---------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.directory, "manifest.json")

    def _read_manifest(self) -> Dict[str, Dict]:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _write_manifest(self) -> None:
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._manifest, f, indent=1, sort_keys=True)
        os.replace(tmp, self._manifest_path())

    # -- queries ----------------------------------------------------------

    def all_steps(self):
        return sorted(int(s) for s in self._manifest)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        scored = [(int(s), e["metric"]) for s, e in self._manifest.items()
                  if e.get("metric") is not None]
        if not scored:
            return None
        sign = 1 if self.mode == "min" else -1
        return min(scored, key=lambda kv: (sign * kv[1], -kv[0]))[0]

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:010d}.npz")

    # -- save -------------------------------------------------------------

    def save(self, step: int, tree: Any,
             metadata: Optional[Dict[str, float]] = None,
             metric: Optional[float] = None) -> str:
        """Write ``tree`` for ``step``; returns the checkpoint path.  With
        ``async_save`` the host copy happens here and the disk write on a
        worker thread."""
        host_tree = unflatten(tree, {p: _host(v)
                                      for p, v in flatten(tree)})
        path = self._step_path(step)

        def commit():
            try:
                save_checkpoint(path, host_tree, metadata)
                with self._lock:
                    self._manifest[str(step)] = {
                        "file": os.path.basename(path),
                        "metric": None if metric is None else float(metric),
                    }
                    self._rotate_locked()
                    self._write_manifest()
            except BaseException as e:     # raised by wait() or next save
                self._pending_error = e

        if self.async_save:
            self.wait()                    # one write in flight at a time
            self._pending = threading.Thread(target=commit, daemon=True)
            self._pending.start()
        else:
            commit()
            self._raise_pending_error()
        return path

    def _raise_pending_error(self) -> None:
        e, self._pending_error = self._pending_error, None
        if e is not None:
            raise RuntimeError("checkpoint save failed (no manifest entry "
                               "was written for that step)") from e

    def wait(self) -> None:
        """Block until an in-flight asynchronous save has committed;
        raises what the worker raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        self._raise_pending_error()

    def _rotate_locked(self) -> None:
        steps = sorted(int(s) for s in self._manifest)
        keep = set(steps[-self.max_to_keep:] if self.max_to_keep else steps)
        if self.keep_best:
            sign = 1 if self.mode == "min" else -1
            scored = sorted(
                ((s, self._manifest[str(s)]["metric"]) for s in steps
                 if self._manifest[str(s)].get("metric") is not None),
                key=lambda kv: (sign * kv[1], -kv[0]))
            keep.update(s for s, _ in scored[:self.keep_best])
        for s in steps:
            if s not in keep:
                entry = self._manifest.pop(str(s))
                try:
                    os.remove(os.path.join(self.directory, entry["file"]))
                except OSError:
                    pass

    # -- restore ----------------------------------------------------------

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None):
        """Load ``step`` (default: the latest); returns ``(tree,
        metadata)``."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        if str(step) not in self._manifest:
            raise KeyError(f"step {step} not in manifest "
                           f"(have {self.all_steps()})")
        return load_checkpoint(self._step_path(step), template, shardings)


def save_checkpoint_sharded(*args, **kwargs):
    """The sharded (per-device-shard) format waits for the port's
    meshes."""
    not_ported("save_checkpoint_sharded", sharded=True)


def load_checkpoint_sharded(*args, **kwargs):
    """The sharded (per-device-shard) format waits for the port's
    meshes."""
    not_ported("load_checkpoint_sharded", sharded=True)
