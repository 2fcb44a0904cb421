"""Decode loops replayed as CUDA graphs: the port's counterpart of
``jax.jit`` over a loop body.

The JAX package compiles each decode loop into one program (``lax.scan``
or ``lax.while_loop``, ``taper_tpu/models/transformer.py``,
``taper_tpu/serve.py``).  The port keeps the loop in Python and replays
its body: a :class:`Step` wraps a function over static device buffers
(every value that changes from one step to the next lives in one and is
updated in place; nothing in the function reads a Python value that
changes between calls).  On a CUDA device its first call runs the
function eagerly on a side stream (the warm-up: the kernel library is
built and loaded, and every entry point has set its kernel attributes),
its second call captures the function with ``torch.cuda.CUDAGraph`` and
replays the capture, and every later call replays it.  The warm-up is a
real step, so every call does exactly one step's work.  On the CPU a Step
calls its function: dispatch follows the device, as everywhere in the
port.

* **Counts.** The kernel wrappers count their launches in Python
  (``ops/backend.py``).  A capture launches nothing, so what the captured
  call added to the counts is taken off again and recorded, and every
  replay adds it: a replayed step counts exactly what an eager one does.
  ``chip_smoke.py`` phase 36 traces replayed steps on the device and
  holds their kernels, name by name, to the same steps run eagerly.
* **Generators.** Each ``torch.Generator`` the function draws from is
  registered with the graph, so every replay draws new numbers from it
  and advances it, as an eager step would (the same seed gives the same
  numbers either way).
* **No fallback.** A capture that fails raises; nothing runs the eager
  loop in its place.  A host-to-device copy, or a host sync, inside the
  function raises during the capture.

:func:`program` keeps a loop's programs (a Step with the static buffers
it reads) on the object that owns them, the model or the engine, in a
bounded store keyed by their static configuration, as the JAX package
caches ``_offline_program`` with ``functools.lru_cache``
(``taper_tpu/serve.py:122``): a repeated call with the same shapes and
settings replays the graph captured by the first, and the programs go
with their owner.  A program draws from a generator of its own;
:func:`draw_from` and :func:`give_back` carry a caller's generator state
into it before a loop and back after, so the caller's generator advances
as an eager loop would advance it and never keys a program.
"""

from __future__ import annotations

import collections

import torch

from taper_tpu_torch.ops import backend

# programs kept for one owner by :func:`program`, least recently used
# dropped first
MAX_PROGRAMS = 8

_side_streams = {}


def _side_stream(device):
    device = torch.device(device)
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    return _side_streams[device]


class Step:
    """``fn()`` (one step of a decode loop over static buffers), replayed
    as a CUDA graph on a CUDA ``device`` and called as it is on the CPU.
    ``generators``: every ``torch.Generator`` ``fn`` draws from."""

    def __init__(self, fn, device, generators=()):
        self.fn = fn
        self.device = torch.device(device)
        self.generators = tuple(g for g in generators if g is not None)
        self.graph = None
        self.warm = False
        self.replays = 0
        self.pool_bytes = 0       # the capture's private memory pool
        self._delta = None

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self.fn()
            return
        if self.graph is None:
            if not self.warm:
                self._warm_up()
                return
            self._capture()
        self._replay()

    def _replay(self):
        self.graph.replay()
        backend.add_counts(self._delta)
        self.replays += 1

    def _warm_up(self):
        side = _side_stream(self.device)
        main = torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.fn()
        main.wait_stream(side)
        self.warm = True

    def _capture(self):
        side = _side_stream(self.device)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        snap = backend.count_snapshot()
        try:
            with torch.cuda.graph(graph, stream=side):
                self.fn()
        finally:
            # the capture launched nothing: its counts come off again
            delta = backend.counts_since(snap)
            backend.add_counts(delta, -1)
        self._delta = delta
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph = graph


class Program:
    """A decode loop's captured steps and the static buffers they read:
    attributes as the loop sets them (:func:`program` builds one)."""

    def __init__(self, **buffers):
        self.__dict__.update(buffers)

    def steps(self):
        return [v for v in self.__dict__.values() if isinstance(v, Step)]

    def nbytes(self) -> int:
        """Bytes of the device tensors the program holds (its static
        buffers and caches), one count for each storage."""
        return tensor_bytes(list(self.__dict__.values()))

    def pool_bytes(self) -> int:
        return sum(s.pool_bytes for s in self.steps())


def tensor_bytes(tree) -> int:
    """Bytes of the distinct tensor storages in a nest of lists, tuples
    and dicts."""
    seen, total = set(), 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if torch.is_tensor(x):
            s = x.untyped_storage()
            if s.data_ptr() not in seen:
                seen.add(s.data_ptr())
                total += s.nbytes()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return total


class _Store(collections.OrderedDict):
    """An owner's programs.  A copy of the owner starts with none: a
    program reads its own owner's weights and buffers."""

    def __deepcopy__(self, memo):
        return _Store()

    def __reduce__(self):
        return _Store, ()


def _store(owner) -> _Store:
    store = owner.__dict__.get("_graph_programs")
    if store is None:
        store = owner.__dict__["_graph_programs"] = _Store()
    return store


def program(owner, key, build, keep: bool = True):
    """``owner``'s cached program for ``key``, made by ``build()`` on a
    miss.  ``keep=False`` builds one for this call alone and caches
    nothing (a program whose buffers go back to the caller)."""
    if not keep:
        return build()
    store = _store(owner)
    prog = store.pop(key, None)
    if prog is None:
        prog = build()
    store[key] = prog
    while len(store) > MAX_PROGRAMS:
        store.popitem(last=False)
    return prog


def programs(owner) -> list:
    """``owner``'s cached programs, least recently used first."""
    return list(_store(owner).values())


def clear(owner) -> None:
    """Drop ``owner``'s cached programs (their graphs and buffers with
    them)."""
    _store(owner).clear()


def draw_from(own, generator) -> None:
    """Before a loop: ``own`` (a program's generator) takes the state of
    the caller's ``generator``, or the seed 0 when none is given (JAX's
    default key, ``PRNGKey(0)``, every call)."""
    if generator is None:
        own.manual_seed(0)
    else:
        own.set_state(generator.get_state())


def give_back(own, generator) -> None:
    """After a loop: the caller's ``generator`` takes the state ``own``
    reached, as if the loop had drawn from it."""
    if generator is not None:
        generator.set_state(own.get_state())
