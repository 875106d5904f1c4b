"""The data-parallel mesh on ``torch.distributed``: one process a rank.

Counterpart of ``ciao_tpu/parallel/mesh.py``. JAX maps the finite-sum
index ``i`` onto a device mesh and lets ``shard_map`` hand each device
its rows; here each rank is a process of its own and holds only its
rows. The caller starts the processes and initializes the default
process group (``torch.distributed.init_process_group``), as a JAX
caller runs ``jax.distributed.initialize``; :func:`make_mesh` wraps that
group:

  * axis ``"data"``: the oracle's stacked rows (A, b, int8 row scales,
    diagonals, ELL columns) and the solver tables are cut by their
    leading N axis, rank r holding rows [r·N/D, (r+1)·N/D); the x-sized
    aggregates (``av``, the SVRG anchors, ProShI's coupling sum) are
    ``all_reduce`` sums over the group;
  * axis ``"model"``: the coordinate axis of the tensor-parallel solvers
    (:func:`make_mesh_2d`): rank (d, m) of a (D, M) mesh holds rows
    [d·N/D, (d+1)·N/D) and columns [m·n/M, (m+1)·n/M) of the rows, and
    the x-sized vectors cut to its columns.

Backends: NCCL for one process a GPU; gloo for the CPU, and for several
processes on one GPU (NCCL refuses two ranks on one device), where it
sums CUDA tensors too.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D data mesh: the process group its
    collectives run on (None: the default group), its rank, the group's
    size D and the device that holds its rows."""

    group: Any
    rank: int
    size: int
    device: torch.device

    @property
    def shape(self) -> dict:
        """``{"data": D}``, as a JAX mesh's ``shape``."""
        return {DATA_AXIS: self.size}

    def rows(self, N: int) -> tuple:
        """This rank's rows [lo, hi) of N."""
        n_loc = N // self.size
        return self.rank * n_loc, (self.rank + 1) * n_loc

    def span(self, axis: str, size: int) -> tuple:
        """This rank's part [lo, hi) of a dimension of ``size`` cut over
        ``axis``."""
        return self.rows(size)


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """One rank's view of a (data, model) mesh of D·M ranks: rank r sits
    at (d, m) = (r // M, r % M). ``data_group`` is the D ranks that share
    m (the sums over samples), ``model_group`` the M ranks that share d
    (the sums over coordinates); ``group`` holds all D·M. ``rank`` is
    the rank's place in the mesh."""

    group: Any
    data_group: Any
    model_group: Any
    rank: int
    D: int
    M: int
    device: torch.device

    @property
    def size(self) -> int:
        return self.D * self.M

    @property
    def d(self) -> int:
        """The rank's data row: its block of samples."""
        return self.rank // self.M

    @property
    def m(self) -> int:
        """The rank's model column: its block of coordinates."""
        return self.rank % self.M

    @property
    def shape(self) -> dict:
        """``{"data": D, "model": M}``, as a JAX mesh's ``shape``."""
        return {DATA_AXIS: self.D, MODEL_AXIS: self.M}

    def rows(self, N: int) -> tuple:
        """This rank's rows [lo, hi) of N."""
        k = N // self.D
        return self.d * k, (self.d + 1) * k

    def cols(self, n: int) -> tuple:
        """This rank's columns [lo, hi) of n."""
        k = n // self.M
        return self.m * k, (self.m + 1) * k

    def span(self, axis: str, size: int) -> tuple:
        return self.rows(size) if axis == DATA_AXIS else self.cols(size)


def _mesh_device(device, rank: int) -> torch.device:
    """The rank's device: the one named, else card (local rank mod the
    cards seen); with no card and none named it raises, as
    ``runtime.entry_device`` does."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: no CUDA device: the ranks run on the card; pass "
            "device='cpu' to run them on the CPU")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


@contextlib.contextmanager
def process_group(device):
    """The default process group of a script's run on ``device``, the
    counterpart of ``jax.distributed.initialize`` in JAX's examples. A
    group that is already initialized is used as it is. Else, when
    ``RANK`` and ``WORLD_SIZE`` are set (as ``torchrun`` sets them with
    ``MASTER_ADDR``, ``MASTER_PORT`` and ``LOCAL_RANK``), the group is
    initialized from the environment
    (``init_method="env://"``); otherwise it is one rank of its own. The
    backend is NCCL on the card, gloo on the CPU and where a host runs
    more ranks (``LOCAL_WORLD_SIZE``) than it has cards (NCCL refuses two
    ranks on one device). A group started here is destroyed when the
    block exits."""
    if dist.is_initialized():
        yield
        return
    dev = torch.device(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                   os.environ.get("WORLD_SIZE", "1")))
        nccl = dev.type == "cuda" and local <= torch.cuda.device_count()
        if nccl:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if nccl else "gloo",
                                init_method="env://")
    else:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(n_data: Optional[int] = None, group=None,
              device=None) -> Mesh:
    """A 1-D mesh over the ranks of ``group`` (the default process group
    when None), which the caller has initialized. ``n_data``, when given,
    must be the group's size: a mesh over fewer ranks is a group of its
    own (``torch.distributed.new_group``)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh: no process group: start one process a rank and "
            "call torch.distributed.init_process_group in each first")
    rank = dist.get_rank(group)
    size = dist.get_world_size(group)
    if n_data is not None and n_data != size:
        raise ValueError(
            f"make_mesh: n_data={n_data}, but the group has {size} ranks; "
            f"pass a group of {n_data} ranks (torch.distributed.new_group)")
    return Mesh(group=group, rank=rank, size=size,
                device=_mesh_device(device, rank))


def make_mesh_2d(n_data: int, n_model: int, ranks=None, device=None):
    """A (data, model) mesh of n_data·n_model ranks, the counterpart of
    JAX's ``make_mesh_2d(n_data, n_model, devices)``: ``ranks`` (global
    ranks of the default process group) takes the place of ``devices``,
    the first n_data·n_model by default. Every process of the default
    group calls it, in the same order as its other group creations:
    each creates every group (``torch.distributed.new_group``), as NCCL
    and gloo need. A process outside ``ranks`` gets None."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh_2d: no process group: start one process a rank and "
            "call torch.distributed.init_process_group in each first")
    D, M = int(n_data), int(n_model)
    if D < 1 or M < 1:
        raise ValueError(f"make_mesh_2d: n_data={n_data} and "
                         f"n_model={n_model} must be at least 1")
    world = dist.get_world_size()
    ranks = list(range(D * M)) if ranks is None else [int(r) for r in ranks]
    if len(ranks) != D * M or len(set(ranks)) != len(ranks) or not all(
            0 <= r < world for r in ranks):
        raise ValueError(
            f"make_mesh_2d: a ({D}, {M}) mesh takes {D * M} distinct ranks "
            f"of the {world} in the process group, not {ranks}")
    whole = dist.new_group(ranks)
    data = [dist.new_group([ranks[d * M + m] for d in range(D)])
            for m in range(M)]
    model = [dist.new_group(ranks[d * M:(d + 1) * M]) for d in range(D)]
    me = dist.get_rank()
    if me not in ranks:
        return None
    r = ranks.index(me)
    return Mesh2D(group=whole, data_group=data[r % M],
                  model_group=model[r // M], rank=r, D=D, M=M,
                  device=_mesh_device(device, me))


# ---------------------------------------------------------------------------
# placement: the leaves of an oracle (its buffers and parameters, by their
# dotted names) or of a state (its fields)
# ---------------------------------------------------------------------------

def _named_leaves(obj):
    """(name, tensor) pairs of an oracle's buffers and parameters, a
    NamedTuple's or dict's tensor fields, or a lone tensor ("")."""
    if isinstance(obj, nn.Module):
        yield from obj.named_buffers()
        yield from obj.named_parameters()
    elif isinstance(obj, torch.Tensor):
        yield "", obj
    else:
        items = obj._asdict().items() if hasattr(obj, "_asdict") else (
            obj.items())
        for k, v in items:
            if isinstance(v, torch.Tensor):
                yield k, v


def data_specs(obj, N: int, axis: str = DATA_AXIS) -> dict:
    """The placement of each leaf, by name: ``(axis, None, ...)`` for a
    leaf whose LEADING dimension is the term count N (cut by rows), ``()``
    for every other leaf (whole on each rank). The single placement rule
    of finite-sum problems: the rows of the oracle (A (N, n), b (N,),
    diagonals (N, n), ...) and the solver tables (s (N, n), γ (N,)) are
    cut; x-sized vectors and scalars are not.

    An oracle opts fields out of the shape rule with a class attribute
    ``dp_replicated = ("field", ...)``, matched against the last part of
    a leaf's name: needed where a whole field's leading dimension can
    equal N (the hybrid sparse oracle's (D,) ``hot_cols`` when N = D)."""
    repl = frozenset(getattr(obj, "dp_replicated", ()) or ())
    specs = {}
    for name, t in _named_leaves(obj):
        if name.rsplit(".", 1)[-1] in repl:
            specs[name] = ()
        elif t.dim() >= 1 and t.shape[0] == N:
            specs[name] = (axis,) + (None,) * (t.dim() - 1)
        else:
            specs[name] = ()
    return specs


def replicated_specs(obj) -> dict:
    """Every leaf whole on each rank."""
    return {name: () for name, _ in _named_leaves(obj)}


def _placed(t, spec, mesh):
    """``t`` placed by ``spec``, one mesh axis or None a dimension: a cut
    leaf is copied, so the rank keeps only its part and the whole tensor
    can be freed; a whole leaf moves to the mesh's device (no copy when
    it is there already)."""
    if not any(spec):
        return t.to(mesh.device)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if axis not in mesh.shape:
            raise ValueError(f"placement {spec} names an axis the mesh lacks "
                             f"(its axes are {tuple(mesh.shape)})")
        lo, hi = mesh.span(axis, t.shape[dim])
        t = t.narrow(dim, lo, hi - lo)
    return t.to(mesh.device, memory_format=torch.contiguous_format,
                copy=True)


def _module_copy(m: nn.Module, place, prefix: str = ""):
    """A copy of the module tree ``m`` whose buffers and parameters are
    ``place(name, tensor)``; nothing else is copied."""
    new = copy.copy(m)
    new._buffers = type(m._buffers)(
        (k, None if v is None else place(prefix + k, v))
        for k, v in m._buffers.items())
    new._parameters = type(m._parameters)(
        (k, None if v is None else nn.Parameter(
            place(prefix + k, v.detach()), requires_grad=v.requires_grad))
        for k, v in m._parameters.items())
    new._modules = type(m._modules)(
        (k, None if v is None else _module_copy(v, place, f"{prefix}{k}."))
        for k, v in m._modules.items())
    return new


def put_specs(obj, mesh, specs: dict):
    """``obj`` (an oracle, a NamedTuple or dict of tensors, a tensor)
    with each leaf of ``specs`` placed on this rank: its part where the
    spec cuts an axis of the mesh, else whole; on the mesh's device."""
    def place(name, t):
        return _placed(t, specs.get(name, ()), mesh)

    if isinstance(obj, nn.Module):
        return _module_copy(obj, place)
    if isinstance(obj, torch.Tensor):
        return place("", obj)
    if hasattr(obj, "_asdict"):
        return obj._replace(**{k: place(k, v) for k, v in _named_leaves(obj)})
    return {k: place(k, v) if isinstance(v, torch.Tensor) else v
            for k, v in obj.items()}


def shard_finite_sum(F, mesh: Mesh, N: Optional[int] = None,
                     axis: str = DATA_AXIS):
    """This rank's part of the oracle ``F``: the leaves with leading
    dimension N cut to the rank's rows, the rest whole, all on the mesh's
    device. The part keeps the global constants (a least-squares
    ``scale`` of N stays N), and its ``num_terms`` is that of JAX's
    oracle inside ``shard_map``: the local row count for oracles that
    count their rows, the static count for those that hold one
    (``SqrDistBox``, ``ZeroOracle``). The part records (N, D, rank), so a
    DP facade takes it as it is."""
    if N is None:
        N = F.num_terms
    if N % mesh.size:
        raise ValueError(f"shard_finite_sum: N={N} must divide evenly over "
                         f"the {mesh.size} ranks of the data axis")
    part = put_specs(F, mesh, data_specs(F, N, axis))
    part.dp_shard = (int(N), mesh.size, mesh.rank)
    return part
