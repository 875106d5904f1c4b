"""Checkpoint / resume.

Counterpart of ``ciao_tpu/checkpoint/__init__.py``. Every solver state of
the port is a NamedTuple of tensors, Python scalars (``seed``, ``it``,
``status``), ``None`` fields and nested NamedTuples (``SweepState``), so
checkpointing is generic:

  * :func:`save` / :func:`load` — one ``torch.save`` file of any solver
    state (every family; real and complex tensors alike).
  * :func:`save_async` / :func:`load_like` — the counterparts of JAX's
    orbax pair: the state is snapshotted before ``save_async`` returns and
    written by a background thread while the solver keeps stepping;
    ``load_like`` restores into a template state's structure, dtypes and
    devices.

The file holds plain data only: tensors, Python scalars, and for each
NamedTuple its class's module and name, its field names and its values.
So ``torch.load(path, weights_only=True)`` reads it, and :func:`load`
rebuilds only classes that live under ``ciao_tpu_torch``. The format is
the port's own: the JAX package's npz + treedef files and orbax
directories are not read here, nor these files there.

Resume = iterator-mode consumption from a restored state: pass it to
:func:`resume_iterator` and keep stepping.
"""

from __future__ import annotations

import importlib
import os
import threading
from pathlib import Path
from typing import Any

import torch

from ciao_tpu_torch import runtime

FORMAT = "ciao_tpu_torch.checkpoint/1"
PACKAGE = "ciao_tpu_torch"
_SCALARS = (bool, int, float, type(None))


def _encode(node, leaf):
    """The plain-data form of ``node``; each tensor goes through
    ``leaf``."""
    if isinstance(node, torch.Tensor):
        return leaf(node)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        cls = type(node)
        return {"kind": "namedtuple",
                "class": f"{cls.__module__}:{cls.__qualname__}",
                "fields": list(node._fields),
                "values": [_encode(v, leaf) for v in node]}
    if isinstance(node, int) and not isinstance(node, bool):
        return int(node)  # an IntEnum (Status) is stored as its int
    if isinstance(node, _SCALARS):
        return node
    raise TypeError(f"checkpoint: cannot store a {type(node).__name__}; a "
                    "state holds tensors, Python scalars, None and "
                    "NamedTuples")


def _state_class(name: str, fields):
    """The NamedTuple class ``module:qualname``, refused unless it lives
    under ``ciao_tpu_torch`` and has the stored fields."""
    module, _, qualname = name.partition(":")
    if module != PACKAGE and not module.startswith(PACKAGE + "."):
        raise ValueError(f"checkpoint: refusing class {name!r} outside "
                         f"{PACKAGE}")
    try:
        obj = importlib.import_module(module)
        for part in qualname.split("."):
            obj = getattr(obj, part)
    except (ImportError, AttributeError) as e:
        raise ValueError(f"checkpoint: no class {name!r}") from e
    if not (isinstance(obj, type) and issubclass(obj, tuple)
            and list(getattr(obj, "_fields", ())) == list(fields)):
        raise ValueError(f"checkpoint: {name!r} is not a NamedTuple with "
                         f"fields {list(fields)}")
    return obj


def _decode(node, leaf):
    if isinstance(node, torch.Tensor):
        return leaf(node)
    if isinstance(node, dict):
        if node.get("kind") != "namedtuple":
            raise ValueError(f"checkpoint: unknown node {node.get('kind')!r}")
        return _state_class(node["class"], node["fields"])(
            *(_decode(v, leaf) for v in node["values"]))
    if isinstance(node, _SCALARS):
        return node
    raise ValueError(f"checkpoint: unexpected {type(node).__name__} in the "
                     "file")


def _map_tensors(node, fn):
    """The plain-data tree ``node`` with each tensor ``t`` as ``fn(t)``."""
    if isinstance(node, torch.Tensor):
        return fn(node)
    if isinstance(node, dict):
        return {k: _map_tensors(v, fn) for k, v in node.items()}
    if isinstance(node, list):
        return [_map_tensors(v, fn) for v in node]
    return node


def _own_storage(t: torch.Tensor) -> torch.Tensor:
    """``t`` detached, copied when it views a larger storage (torch.save
    writes a view's whole storage)."""
    t = t.detach()
    if t.untyped_storage().nbytes() > t.numel() * t.element_size():
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _write(path: Path, tree) -> None:
    """``tree`` to ``path`` through a temporary file and a rename, so that
    a file at ``path`` is always whole."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    # a file name, not a Python file object: torch.save then writes the
    # tensors' bytes from C++ rather than through Python calls, which would
    # hold the interpreter lock against a solver stepping beside save_async
    torch.save({"format": FORMAT, "state": tree}, str(tmp))
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)


def _read(path, map_location):
    obj = torch.load(Path(path), map_location=map_location,
                     weights_only=True)
    if not (isinstance(obj, dict) and obj.get("format") == FORMAT):
        raise ValueError(f"checkpoint: {path} is not a {FORMAT} file")
    return obj["state"]


def save(path, state: Any) -> None:
    """Write a solver state to the file ``path``. CUDA tensors are saved
    as they are (torch.save copies them to the host)."""
    _write(Path(path), _encode(state, _own_storage))


def load(path, device=None) -> Any:
    """The solver state saved at ``path`` by :func:`save` or
    :func:`save_async`, every tensor on ``device`` (default:
    :func:`runtime.default_device`, the card when there is one)."""
    device = torch.device(runtime.default_device() if device is None
                          else device)
    return _decode(_read(path, device), lambda t: t.to(device))


# save_async's copies to the host go through two pinned buffers of this
# many bytes in turn, so that the copy engine moves them beside the
# solver's launches: pinning one buffer the size of the state would hold
# the driver, and with it the solver's launches, for as long as that takes
_STAGE_BYTES = 64 << 20


def _staged_copy(srcs, stream) -> list:
    """Pageable host copies of the CUDA tensors ``srcs``, moved on
    ``stream`` through two pinned buffers in turn."""
    stage = [torch.empty(_STAGE_BYTES, dtype=torch.uint8, pin_memory=True)
             for _ in range(2)]
    flight = [None, None]  # each buffer's copy: (event, host bytes, bytes)

    def drain(i):
        if flight[i] is not None:
            ev, dst, src = flight[i]
            ev.synchronize()
            dst.copy_(src)
            flight[i] = None

    out, k = [], 0
    for t in srcs:
        h = torch.empty(t.shape, dtype=t.dtype)
        out.append(h)
        src = t.reshape(-1).view(torch.uint8)
        dst = h.reshape(-1).view(torch.uint8)
        for off in range(0, src.numel(), _STAGE_BYTES):
            m, i = min(_STAGE_BYTES, src.numel() - off), k % 2
            k += 1
            drain(i)
            with torch.cuda.stream(stream):
                stage[i][:m].copy_(src[off:off + m], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
            flight[i] = (ev, dst[off:off + m], stage[i][:m])
    drain(k % 2)
    drain((k + 1) % 2)
    return out


class AsyncSave:
    """A write of :func:`save_async` in flight."""

    def __init__(self, path: Path, state: Any):
        self._error = None
        self._cuda = []
        # the snapshot: CPU tensors copied now, CUDA tensors copied on
        # their current stream, so that the copy sees every launch queued
        # before this call and none queued after it
        tree = _encode(state, self._snapshot)
        self._events = {}
        for t in self._cuda:
            if t.device not in self._events:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(t.device))
                self._events[t.device] = ev
        self._tree = tree
        self._thread = threading.Thread(target=self._run, args=(path,),
                                        name="ciao-checkpoint", daemon=True)
        self._thread.start()

    def _snapshot(self, t: torch.Tensor) -> torch.Tensor:
        snap = t.detach().clone(memory_format=torch.contiguous_format)
        if snap.is_cuda:
            self._cuda.append(snap)
        return snap

    def _run(self, path: Path) -> None:
        try:
            host = {}
            for dev, ev in self._events.items():
                stream = torch.cuda.Stream(dev)
                stream.wait_event(ev)
                srcs = [t for t in self._cuda if t.device == dev]
                host.update(zip(map(id, srcs), _staged_copy(srcs, stream)))
            tree = _map_tensors(self._tree, lambda t: host.get(id(t), t))
            # the device copies go back to the allocator before the write
            self._tree = self._cuda = host = None
            _write(path, tree)
        except Exception as e:  # re-raised by wait_until_finished
            self._error = e
        finally:
            self._tree = self._cuda = None

    def done(self) -> bool:
        """Whether the write has ended (well or not)."""
        return not self._thread.is_alive()

    def wait_until_finished(self) -> None:
        """Block until the file is written; raise what the write raised."""
        self._thread.join()
        if self._error is not None:
            raise self._error


def save_async(path, state: Any) -> AsyncSave:
    """Write a solver state to ``path`` in the background (counterpart of
    JAX's orbax ``save_async``). The snapshot is taken before this returns:
    each tensor is copied (a CUDA tensor on its device, in stream order),
    so the solver may step on, and even write the state's tensors in
    place, while a thread copies the snapshot to the host on a stream of
    its own (through two pinned buffers of 64 MiB) and writes the file.
    It costs one copy of the state in device memory until the host has
    it. Call ``.wait_until_finished()`` before relying on the file."""
    return AsyncSave(Path(path), state)


def _like(loaded, like, where: str):
    if isinstance(like, torch.Tensor):
        if not isinstance(loaded, torch.Tensor) or loaded.shape != like.shape:
            raise ValueError(f"checkpoint: {where} does not match the "
                             f"template's tensor of shape {tuple(like.shape)}")
        return loaded.to(device=like.device, dtype=like.dtype)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        if type(loaded) is not type(like):
            raise ValueError(f"checkpoint: {where} is a "
                             f"{type(loaded).__name__}, the template a "
                             f"{type(like).__name__}")
        return type(like)(*(_like(a, b, f"{where}.{f}")
                            for a, b, f in zip(loaded, like, like._fields)))
    return loaded


def load_like(path, like: Any) -> Any:
    """The state saved at ``path``, restored into ``like``'s structure,
    dtypes and devices (counterpart of JAX's ``load_orbax(path, like)``):
    ``like`` is a state of the same solver, e.g. its init state; every
    tensor takes the dtype and device of the template's tensor in its
    place, and a field whose class or shape differs raises
    ``ValueError``."""
    return _like(_decode(_read(path, "cpu"), lambda t: t), like, "state")


def resume_iterator(iterable, state, rebase: bool = False):
    """Continue a :class:`~ciao_tpu_torch.solvers.base.SolverIterable`
    from a restored state: yields ``state``, then keeps stepping.

    Pass ``rebase=True`` when ``state`` was produced under a DIFFERENT
    oracle row storage than ``iterable``'s (the staged bf16/int8 → f32
    schedules): the solver's running average otherwise keeps the old
    operator's bias (``saga.saga_rebase``). The rebase costs one pass over
    the data and is an identity for the families whose state is
    storage-consistent by construction; an iterable with no hook raises
    ``ValueError``. A plain same-oracle resume keeps the default, a
    bit-exact continuation. The stream is the iterable's own
    (``SolverIterable.resume``), so it stops where a fresh run would."""
    if rebase:
        fn = getattr(iterable, "_rebase_fn", None)
        if fn is None:
            raise ValueError(
                "rebase=True but this iterable has no storage-rebase hook")
        state = fn(state)
    yield from iterable.resume(state)


__all__ = ["save", "load", "save_async", "load_like", "resume_iterator",
           "AsyncSave"]
