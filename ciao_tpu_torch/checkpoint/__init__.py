"""Checkpoint / resume.

Counterpart of ``ciao_tpu/checkpoint/__init__.py``. Every solver state of
the port is a NamedTuple of tensors, Python scalars (``seed``, ``it``,
``status``), ``None`` fields and nested NamedTuples (``SweepState``), so
checkpointing is generic:

  * :func:`save` / :func:`load` — one ``torch.save`` file of any solver
    state (every family; real and complex tensors alike). With
    ``mesh=``, a DP or TP state's cut fields are gathered over the mesh
    and its rank 0 writes the global state, as JAX's ``save`` gathers
    sharded arrays; without one, ``save`` refuses a process group of
    more than one rank.
  * :func:`save_async` / :func:`load_like` — the state is snapshotted
    before ``save_async`` returns and written by a background thread
    while the solver keeps stepping; ``load_like`` restores into a
    template state's structure, dtypes and devices.
  * :func:`save_async` with ``mesh=`` / :func:`load_orbax` — the sharded
    checkpoint of the DP and TP states, the counterparts of JAX's orbax
    pair: each rank writes its own parts into the directory, and
    ``load_orbax`` restores onto any mesh the shapes divide over (the
    elastic restore), each rank reading only its own rows and columns.

The files hold plain data only: tensors, Python scalars, and for each
NamedTuple its class's module and name, its field names and its values.
So ``torch.load(path, weights_only=True)`` reads them, and :func:`load`
rebuilds only classes that live under ``ciao_tpu_torch``. A sharded
checkpoint is a directory: ``manifest.pt`` (the state class, each
tensor field's global shape, dtype and placement, the Python scalars and
the mesh's (D, M)) and one ``shard-<d>-<m>.pt`` a rank with the parts it
owns. Which fields are cut, and over which axis, is stated once per
state class in :mod:`ciao_tpu_torch.parallel.placement`. The format is
the port's own: the JAX package's npz + treedef files and orbax
directories are not read here, nor these files there.

Resume = iterator-mode consumption from a restored state: pass it to
:func:`resume_iterator` and keep stepping.
"""

from __future__ import annotations

import importlib
import os
import struct
import threading
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist

from ciao_tpu_torch import runtime

FORMAT = "ciao_tpu_torch.checkpoint/1"
SHARDED_FORMAT = "ciao_tpu_torch.checkpoint.sharded/1"
MANIFEST = "manifest.pt"
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


def _write(path: Path, obj) -> None:
    """``obj`` to ``path`` through a temporary file and a rename, so that
    a file at ``path`` is always whole."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    # a file name, not a Python file object: torch.save then writes the
    # tensors' bytes from C++ rather than through Python calls, which would
    # hold the interpreter lock against a solver stepping beside save_async
    torch.save(obj, str(tmp))
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)


def _read(path, map_location, fmt=FORMAT, mmap=False):
    """The file's object (its ``"state"`` for a ``FORMAT`` file); with
    ``mmap`` its tensors map the file, so a slice reads only its own
    bytes."""
    obj = torch.load(Path(path), map_location=map_location,
                     weights_only=True, mmap=mmap)
    if not (isinstance(obj, dict) and obj.get("format") == fmt):
        raise ValueError(f"checkpoint: {path} is not a {fmt} file")
    return obj["state"] if fmt == FORMAT else obj


def _refuse_group(who: str) -> None:
    """Raise when the default process group has more than one rank: each
    rank would write its own part to one path."""
    if dist.is_available() and dist.is_initialized() and (
            dist.get_world_size() > 1):
        raise ValueError(
            f"checkpoint.{who}: the process group has "
            f"{dist.get_world_size()} ranks, and a DP or TP state holds "
            f"only the rank's part: pass mesh= (save gathers the state to "
            f"the mesh's rank 0; save_async(..., mesh=) writes each rank's "
            f"parts, load_orbax restores them)")


def save(path, state: Any, mesh=None) -> None:
    """Write a solver state to the file ``path``. CUDA tensors are saved
    as they are (torch.save copies them to the host).

    ``mesh``: the DP or TP mesh of a parallel solver's state. Every rank
    of it calls ``save``; each cut field is gathered to the mesh's rank
    0, which writes the global state (readable by :func:`load` in one
    process, or by :func:`load_orbax` onto any mesh), and every rank
    returns after the write, raising if it failed. Without a mesh, a
    process group of more than one rank raises ``ValueError``."""
    if mesh is None:
        _refuse_group("save")
        _write(Path(path), {"format": FORMAT,
                            "state": _encode(state, _own_storage)})
        return
    specs, grid = _checked_specs(state, mesh)
    D, M, d, m = grid
    coords = _all_coords(mesh, grid)
    gloo = dist.get_backend(mesh.group) == "gloo"
    dst = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
    fields = {}
    for name, v in zip(state._fields, state):
        spec = specs.get(name)
        if spec is None or not any(spec):
            fields[name] = v
            continue
        part = v.detach().contiguous()
        part = part.cpu() if gloo else part
        parts = ([torch.empty_like(part) for _ in coords]
                 if (d, m) == (0, 0) else None)
        dist.gather(part, parts, dst=dst, group=mesh.group)
        if parts is not None:
            shape = _global_shape(v, spec, grid)
            whole = torch.empty(shape, dtype=v.dtype)
            for (d_, m_), p in zip(coords, parts):
                whole[_slices(_box(spec, shape, grid, d_, m_))] = p.cpu()
            fields[name] = whole
    error = None
    if (d, m) == (0, 0):
        try:
            _write(Path(path), {"format": FORMAT, "state": _encode(
                type(state)(**fields), _own_storage)})
        except Exception as e:  # raised on every rank below
            error = e
    _agree(mesh, error, "save")


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
        self._start(path, lambda: {"format": FORMAT,
                                   "state": _encode(state, self._snapshot)})

    def _start(self, path: Path, make) -> None:
        """Snapshot ``make()``'s tree (its tensors through
        ``_snapshot``) and start the thread that writes it to ``path``."""
        self._error = None
        self._cuda = []
        # the snapshot: CPU tensors copied now, CUDA tensors copied on
        # their current stream, so that the copy sees every launch queued
        # before this call and none queued after it
        tree = make()
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


# ---------------------------------------------------------------------------
# the sharded checkpoint: a state's placement on a mesh
# ---------------------------------------------------------------------------

def _grid(mesh) -> tuple:
    """(D, M, d, m): the mesh's shape and the rank's place in it; a 1-D
    mesh is (D, 1), no mesh one rank holding everything."""
    if mesh is None:
        return 1, 1, 0, 0
    if hasattr(mesh, "M"):
        return mesh.D, mesh.M, mesh.d, mesh.m
    return mesh.size, 1, mesh.rank, 0


def _global_shape(t: torch.Tensor, spec, grid) -> tuple:
    D, M = grid[:2]
    return tuple(s * {None: 1, "data": D, "model": M}[a]
                 for s, a in zip(t.shape, spec))


def _box(spec, shape, grid, d: int, m: int) -> tuple:
    """The [lo, hi) of each dimension of the part of a field of global
    ``shape`` that rank (d, m) holds."""
    D, M = grid[:2]
    out = []
    for size, axis in zip(shape, spec):
        if axis is None:
            out.append((0, size))
            continue
        k, at = (size // D, d) if axis == "data" else (size // M, m)
        out.append((at * k, (at + 1) * k))
    return tuple(out)


def _slices(box) -> tuple:
    return tuple(slice(lo, hi) for lo, hi in box)


def _owns(spec, d: int, m: int) -> bool:
    """Whether rank (d, m) writes its part of a field placed by ``spec``:
    the first rank of each axis the field is whole over."""
    return (d == 0 or "data" in spec) and (m == 0 or "model" in spec)


def _bits(v) -> torch.Tensor:
    """A field's bits as int64 (a tensor's elements, a Python scalar's
    value), for the comparison across the ranks."""
    if v is None:
        return torch.zeros(1, dtype=torch.int64)
    if isinstance(v, float):
        return torch.tensor(struct.unpack("<q", struct.pack("<d", v)),
                            dtype=torch.int64)
    if not isinstance(v, torch.Tensor):
        return torch.tensor([int(v)], dtype=torch.int64)
    t = v.detach()
    if t.is_complex():
        t = torch.view_as_real(t)
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    t = t.contiguous().reshape(-1)
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()]).to(torch.int64)


def _replicas(mesh, spec):
    """The axes over which the ranks hold the same part of a field placed
    by ``spec``: "all", "data" or "model", or None where no two ranks
    do."""
    over = [a for a in ("data", "model") if a not in spec
            and (a == "data" or hasattr(mesh, "M"))]
    if len(over) == 2 or (over == ["data"] and not hasattr(mesh, "M")):
        return "all"
    return over[0] if over else None


def _check_replicated(state, specs: dict, mesh) -> None:
    """Raise ``ValueError`` on every rank unless each field that
    ``specs`` places whole over an axis (and each Python scalar) is bit
    for bit the same on the ranks of that axis: a max and a min of its
    bits, all-reduced over each group of replicas. A field the placement
    table forgot to cut then fails here, rather than being saved from one
    rank."""
    groups = {"all": [], "data": [], "model": []}
    for name, v in zip(state._fields, state):
        if isinstance(v, tuple):
            raise TypeError(f"checkpoint: the sharded checkpoint takes a "
                            f"flat state; {type(state).__name__}.{name} is "
                            f"a {type(v).__name__}")
        over = (_replicas(mesh, specs[name]) if isinstance(v, torch.Tensor)
                else "all")
        if over is not None:
            groups[over].append((name, _bits(v)))
    bad = []
    for over, items in groups.items():
        if not items:
            continue
        group = {"all": mesh.group, "data": getattr(mesh, "data_group", None),
                 "model": getattr(mesh, "model_group", None)}[over]
        flat = torch.cat([b.to(mesh.device) for _, b in items])
        hi, lo = flat.clone(), flat.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        diff = (hi != lo).cpu()
        at = 0
        for name, b in items:
            if bool(diff[at:at + b.numel()].any()):
                bad.append(name)
            at += b.numel()
    if bad:
        raise ValueError(
            f"checkpoint: {type(state).__name__} fields {bad} are placed "
            f"whole (ciao_tpu_torch.parallel.placement) but differ across "
            f"the ranks that should hold them alike")


def _checked_specs(state, mesh):
    """(each tensor field's spec on ``mesh``, the grid), after the check
    of the fields placed whole."""
    from ciao_tpu_torch.parallel.placement import state_specs

    specs = state_specs(state, mesh)
    _check_replicated(state, specs, mesh)
    return specs, _grid(mesh)


def _all_coords(mesh, grid) -> list:
    """(d, m) of each rank of the mesh's group, in group-rank order."""
    mine = torch.tensor(grid[2:], dtype=torch.int64, device=mesh.device)
    out = [torch.empty_like(mine) for _ in range(grid[0] * grid[1])]
    dist.all_gather(out, mine, group=mesh.group)
    return [tuple(int(x) for x in t.tolist()) for t in out]


def _agree(mesh, error, who: str) -> None:
    """Raise on every rank of the mesh if any rank's ``error`` is set:
    the rank's own error, or one naming the failure elsewhere."""
    flag = torch.tensor([0 if error is None else 1], dtype=torch.int64,
                        device=mesh.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=mesh.group)
    if error is not None:
        raise error
    if int(flag) != 0:
        raise RuntimeError(f"checkpoint.{who}: the write failed on another "
                           f"rank of the mesh")


def _shard_name(d: int, m: int) -> str:
    return f"shard-{d}-{m}.pt"


def _class_name(state) -> str:
    cls = type(state)
    return f"{cls.__module__}:{cls.__qualname__}"


class ShardedSave(AsyncSave):
    """A write of :func:`save_async` with ``mesh=`` in flight on this
    rank: its own parts go to ``<path>/shard-<d>-<m>.pt`` in the
    background. :meth:`wait_until_finished` is collective: every rank of
    the mesh calls it at the same point of its program (as it does every
    collective); it waits for the rank's write, then the mesh's rank 0
    writes the manifest, which makes the checkpoint whole, and a write
    that failed on any rank raises on every rank."""

    def __init__(self, path: Path, state: Any, mesh):
        D, M, d, m = grid = _grid(mesh)
        self._mesh, self._path = mesh, path
        if (d, m) == (0, 0):
            # before the collective below, so that no rank writes a part
            # while an old manifest still vouches for the directory
            if path.is_file():
                path.unlink()
            path.mkdir(parents=True, exist_ok=True)
            (path / MANIFEST).unlink(missing_ok=True)
        specs, _ = _checked_specs(state, mesh)
        fields, values, parts = {}, {}, {}
        for name, v in zip(state._fields, state):
            if not isinstance(v, torch.Tensor):
                values[name] = _encode(v, None)
                continue
            spec = specs[name]
            shape = _global_shape(v, spec, grid)
            fields[name] = {"spec": list(spec), "shape": list(shape),
                            "dtype": str(v.dtype).replace("torch.", "")}
            if _owns(spec, d, m):
                parts[name] = v
        self._manifest = {"format": SHARDED_FORMAT,
                          "class": _class_name(state),
                          "fields": list(state._fields), "tensors": fields,
                          "values": values, "mesh": [D, M]}
        path.mkdir(parents=True, exist_ok=True)
        self._start(path / _shard_name(d, m), lambda: {
            "format": SHARDED_FORMAT, "at": [d, m],
            "parts": {k: self._snapshot(t) for k, t in parts.items()}})

    def wait_until_finished(self) -> None:
        """Collective: block until every rank's parts and the manifest
        are written; raise on every rank if any write failed."""
        self._thread.join()
        _agree(self._mesh, self._error, "save_async")
        error = None
        if _grid(self._mesh)[2:] == (0, 0):
            try:
                _write(self._path / MANIFEST, self._manifest)
            except Exception as e:  # raised on every rank below
                error = e
        _agree(self._mesh, error, "save_async")


def save_async(path, state: Any, mesh=None) -> AsyncSave:
    """Write a solver state to ``path`` in the background (counterpart of
    JAX's orbax ``save_async``). The snapshot is taken before this returns:
    each tensor is copied (a CUDA tensor on its device, in stream order),
    so the solver may step on, and even write the state's tensors in
    place, while a thread copies the snapshot to the host on a stream of
    its own (through two pinned buffers of 64 MiB) and writes the file.
    It costs one copy of the state in device memory until the host has
    it. Call ``.wait_until_finished()`` before relying on the file.

    ``mesh``: the DP or TP mesh of a parallel solver's state, which makes
    the call collective (every rank of the mesh calls it) and ``path`` a
    directory. Each rank writes the parts it holds of each cut field, as
    :mod:`ciao_tpu_torch.parallel.placement` places them (no rank holds
    the whole table), the fields placed whole once; before it returns, it
    checks that every field placed whole is bit for bit the same across
    the ranks that hold it, and raises ``ValueError`` on every rank if
    not. ``.wait_until_finished()`` is then collective too: the mesh's
    rank 0 writes the manifest once every rank's parts are written.
    Without a mesh, a process group of more than one rank raises
    ``ValueError``."""
    if mesh is None:
        _refuse_group("save_async")
        return AsyncSave(Path(path), state)
    return ShardedSave(Path(path), state, mesh)


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
    dtypes and devices (counterpart of JAX's ``load_orbax(path, like)`` in
    one process): ``like`` is a state of the same solver, e.g. its init
    state; every tensor takes the dtype and device of the template's
    tensor in its place, and a field whose class or shape differs raises
    ``ValueError``."""
    return _like(_decode(_read(path, "cpu"), lambda t: t), like, "state")


def _sources(path: Path, like):
    """(class name, fields, Python values, {field: (global shape, [(lo of
    each dimension, part)])}) of the checkpoint at ``path``: a sharded
    directory (each rank's parts, mapped from their files) or one file of
    :func:`save` / :func:`save_async` (each field one part)."""
    if path.is_dir():
        man = _read(path / MANIFEST, "cpu", SHARDED_FORMAT)
        D, M = man["mesh"]
        grid = (D, M, 0, 0)
        files = {}
        out = {}
        for name, f in man["tensors"].items():
            spec, shape = tuple(f["spec"]), tuple(f["shape"])
            parts = []
            for d in range(D):
                for m in range(M):
                    if not _owns(spec, d, m):
                        continue
                    if (d, m) not in files:
                        files[d, m] = _read(path / _shard_name(d, m), "cpu",
                                            SHARDED_FORMAT, mmap=True)
                    box = _box(spec, shape, grid, d, m)
                    parts.append((tuple(lo for lo, _ in box),
                                  files[d, m]["parts"][name]))
            out[name] = (shape, parts)
        return man["class"], man["fields"], man["values"], out
    tree = _read(path, "cpu", mmap=True)
    if not (isinstance(tree, dict) and tree.get("kind") == "namedtuple"):
        raise ValueError(f"checkpoint: {path} holds no solver state")
    values, out = {}, {}
    for name, v in zip(tree["fields"], tree["values"]):
        if isinstance(v, torch.Tensor):
            out[name] = (tuple(v.shape), [((0,) * v.dim(), v)])
        elif isinstance(v, dict):
            raise ValueError(f"checkpoint: load_orbax takes a flat state; "
                             f"{path} holds a nested {name}")
        else:
            values[name] = v
    return tree["class"], tree["fields"], values, out


def load_orbax(path, like: Any, mesh=None) -> Any:
    """Restore a checkpoint into ``like``'s structure, dtypes, devices
    and placement: the ELASTIC restore. JAX's name is kept; no orbax is
    involved. ``like`` is the init state of the same solver on the mesh
    to restore onto (``mesh``), as in JAX: build it by initializing the
    solver on the surviving or grown mesh. ``path`` is a directory of
    :func:`save_async` with ``mesh=``, from any mesh, or one file of
    :func:`save` or :func:`save_async` (a gathered or one-process state).
    Each rank reads only the rows and columns the new mesh gives it
    (:mod:`ciao_tpu_torch.parallel.placement`), straight from the mapped
    files; the Python scalars (``seed``, ``it``, ``status``, SVRG's
    ``m``) come from the checkpoint. With no mesh, every field is read
    whole.

    Raises ``ValueError`` where the checkpoint's class differs from the
    template's, where a global shape does not divide over the new mesh,
    or where the template's shapes do not match (a per-block field,
    Finito's ``zb`` and ``invg`` or SSNM's ``zb``, moves only where N/D
    is a multiple of the same block size B on both meshes). The
    schedules hash the rank (the TP data row) into the seed, so a run
    restored onto another mesh takes another trajectory; only a resume
    on the same mesh continues bit for bit."""
    from ciao_tpu_torch.parallel.placement import BLOCK_FIELDS, state_specs

    path = Path(path)
    cls, names, values, sources = _sources(path, like)
    if cls != _class_name(like) or list(names) != list(like._fields):
        raise ValueError(f"checkpoint: {path} holds a {cls}, the template "
                         f"is a {_class_name(like)}")
    grid = _grid(mesh)
    specs = state_specs(like, mesh)
    blocks = BLOCK_FIELDS.get(type(like), ())
    fields = {}
    for name, t in zip(like._fields, like):
        if not isinstance(t, torch.Tensor):
            fields[name] = values[name]
            continue
        if name not in sources:
            raise ValueError(f"checkpoint: {path} holds no tensor {name}")
        shape, parts = sources[name]
        spec = specs[name]
        for size, axis in zip(shape, spec):
            k = {None: 1, "data": grid[0], "model": grid[1]}[axis]
            if size % k:
                raise ValueError(
                    f"checkpoint: {name}'s {size} entries along {axis!r} do "
                    f"not divide over the mesh's {k} ranks")
        if len(shape) != t.dim() or _global_shape(t, spec, grid) != shape:
            note = (" (a field of one row a block: N/D must be a multiple of "
                    "the same block size B on both meshes)"
                    if name in blocks else "")
            raise ValueError(
                f"checkpoint: {name} has global shape {shape}, the "
                f"template's {tuple(t.shape)} on this mesh gives "
                f"{_global_shape(t, spec, grid)}{note}")
        box = _box(spec, shape, grid, *grid[2:])
        out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
        for lo, part in parts:
            cut = [(max(a, l), min(b, l + s))
                   for (a, b), l, s in zip(box, lo, part.shape)]
            if any(a >= b for a, b in cut):
                continue
            out[_slices([(a - m0, b - m0) for (a, b), (m0, _) in
                         zip(cut, box)])] = part[_slices(
                             [(a - l, b - l) for (a, b), l in zip(cut, lo)])]
        fields[name] = out
    return type(like)(**fields)


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


__all__ = ["save", "load", "save_async", "load_like", "load_orbax",
           "resume_iterator", "AsyncSave", "ShardedSave"]
