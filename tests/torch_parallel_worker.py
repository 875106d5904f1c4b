"""Rank processes of the port's data-parallel and tensor-parallel CPU
tests.

Imports torch and the port alone, never JAX, so that the processes that
``torch.multiprocessing`` spawns from a test start without it. A test
module builds its cases (numpy problems, configs, each rank's schedule)
in the parent, and :func:`spawn` runs every case on D gloo ranks over a
``FileStore``, one torch thread a rank, returning each rank's results:

    results = spawn(cases, D, tmp_path)   # results[rank][case name]

A case is a dict whose ``"fn"`` names one of the runners below.
"""

from __future__ import annotations

import datetime
import itertools
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ciao_tpu_torch import parallel
from ciao_tpu_torch.oracles import (
    DiagQuadratic, HuberRows, HybridSparseLeastSquares, LeastSquaresRows,
    SparseLeastSquaresELL, SqrDistBox, SquaredHingeRows, SumOracle,
    ZeroOracle,
)
from ciao_tpu_torch.parallel import dp as tdp
from ciao_tpu_torch.prox import (
    IndBox, NormL1, NormL2, NormNuclear, SqrDistPoint, Zero,
)

TIMEOUT = datetime.timedelta(seconds=120)


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.array(a))


def oracle(spec):
    """The whole oracle of a case (numpy data in ``spec["oracle"]``)."""
    o = spec["oracle"]
    kind = o["kind"]
    if kind == "lsq":
        F = LeastSquaresRows(_t(o["A"]), _t(o["b"]), float(o["scale"]))
        return F.with_storage(o["storage"]) if o.get("storage") else F
    if kind == "huber":
        return HuberRows(_t(o["A"]), _t(o["b"]), float(o["delta"]),
                         float(o["scale"]))
    if kind == "sqhinge":
        return SquaredHingeRows(_t(o["A"]), _t(o["b"]), float(o["scale"]))
    if kind == "ell":
        return SparseLeastSquaresELL.from_dense(o["A"], o["b"],
                                                float(o["scale"]),
                                                device="cpu")
    if kind == "hybrid":
        return HybridSparseLeastSquares.from_dense(
            o["A"], o["b"], float(o["scale"]), D=o["D"], device="cpu")
    if kind == "sharing":
        return SumOracle([DiagQuadratic(_t(o["d"]), _t(o["q"])),
                          SqrDistBox(_t(o["lo"]), _t(o["hi"]),
                                     _t(o["eta"]), n_terms=o["n_terms"])])
    raise ValueError(kind)


def prox(spec, key="prox"):
    p = spec.get(key, {"kind": "l1", "lam": 0.0})
    if p["kind"] == "l1":
        return NormL1(_t(p["lam"]))
    if p["kind"] == "zero":
        return Zero()
    if p["kind"] == "sqrdist":
        return SqrDistPoint(_t(p["b"]), _t(p["rho"]))
    if p["kind"] == "l2":
        return NormL2(_t(p["lam"]))
    if p["kind"] == "nuclear":
        return NormNuclear(float(p["lam"]))
    return IndBox(_t(p["lo"]), _t(p["hi"]))


def terms(spec):
    """The case's g, or (g, h) with an ``"h"`` (Davis-Yin), or (g, h, K)
    with a ``"K"`` too (Condat-Vũ: FirstDifference, or with ``"dense"``
    the identity as a DenseMap)."""
    from ciao_tpu_torch.ops.linmap import DenseMap, FirstDifference

    g = prox(spec)
    if "h" not in spec:
        return g
    if "K" not in spec:
        return g, prox(spec, "h")
    if spec["K"] == "dense":
        return g, prox(spec, "h"), DenseMap(torch.eye(len(spec["x0"]),
                                                      dtype=torch.float64))
    return g, prox(spec, "h"), FirstDifference()


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v


def fields(state) -> dict:
    return {k: _np(v) for k, v in state._asdict().items()}


def _sched(spec, key, rank):
    """The rank's explicit schedule: a tensor, or a list of tensors (one
    an outer step of SVRG++)."""
    s = spec.get(key)
    if s is None:
        return None
    s = s[rank]
    if isinstance(s, list):
        return [_t(a) for a in s]
    return _t(s)


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------

def build(mesh, spec):
    """``build_dp_functions`` on the case's config, from init through
    ``spec["steps"]`` steps (``run``, or ``step`` one at a time with
    ``"stepwise"``) on the explicit schedule; the final state's
    fields."""
    N = spec["cfg"]["N"]
    F = parallel.shard_finite_sum(oracle(spec), mesh, N)
    g = terms(spec)
    cfg = tdp.DPCfg(**spec["cfg"])
    init, step, run, rebase = parallel.build_dp_functions(
        spec["family"], mesh, F, g, cfg)
    gamma = spec.get("gamma")
    if gamma is not None:
        gamma = _t(gamma)
        if gamma.dim() == 1:
            gamma = gamma[slice(*mesh.rows(N))].contiguous()
    st = init(_t(spec["x0"]), gamma, spec.get("seed", 0),
              *spec.get("extra", ()))
    starts, idx = _sched(spec, "starts", mesh.rank), _sched(spec, "idx",
                                                           mesh.rank)
    coins = _sched(spec, "coins", mesh.rank)
    if spec.get("stepwise"):
        for t in range(spec["steps"]):
            st = step(st, None if starts is None else starts[t],
                      None if idx is None else idx[t],
                      None if coins is None else bool(coins[t]))
    else:
        st = run(st, spec["steps"], starts=starts, idx=idx, coins=coins)
    if spec.get("rebase"):
        st = rebase(st)
    return fields(st)


def run_vs_step(mesh, spec):
    """The same config from init through ``spec["steps"]`` steps twice on
    the rank's own draws: one ``run`` call (its draws in one pass) and
    ``step`` calls (each its own draw)."""
    N = spec["cfg"]["N"]
    F = parallel.shard_finite_sum(oracle(spec), mesh, N)
    cfg = tdp.DPCfg(**spec["cfg"])
    init, step, run, _ = parallel.build_dp_functions(
        spec["family"], mesh, F, terms(spec), cfg)
    gamma = _t(spec["gamma"])
    if gamma.dim() == 1:
        gamma = gamma[slice(*mesh.rows(N))].contiguous()
    st0 = init(_t(spec["x0"]), gamma, spec.get("seed", 0),
               *spec.get("extra", ()))
    a = run(st0, spec["steps"])
    b = st0
    for _ in range(spec["steps"]):
        b = step(b)
    return dict(run=fields(a), step=fields(b))


def _solver(mesh, spec):
    cls = getattr(parallel, spec["cls"])
    return cls(mesh=mesh, **spec.get("kw", {}))


def _call_args(mesh, spec):
    """The facade call's keywords: F (None without an ``"oracle"``), g,
    L, N, and h and K where the case has them."""
    F = oracle(spec) if spec.get("oracle") is not None else None
    if F is not None and spec.get("shard", True):
        F = parallel.shard_finite_sum(F, mesh, spec.get("N"))
    L = spec.get("L")
    kw = dict(F=F, g=prox(spec), L=None if L is None else _t(L),
              N=spec.get("N"))
    t = terms(spec)
    if isinstance(t, tuple):
        kw["h"] = t[1]
        if len(t) == 3:
            kw["K"] = t[2]
    return kw


def facade(mesh, spec):
    """A facade call (``x``, ``it``), or with ``"take": k`` the fields of
    the k'th state of its iterator."""
    solver = _solver(mesh, spec)
    x0 = _t(spec["x0"])
    kw = _call_args(mesh, spec)
    if "take" in spec:
        states = list(itertools.islice(solver.iterator(x0, **kw),
                                       spec["take"]))
        out = fields(states[-1])
        out["n_states"] = len(states)
        return out
    x, it = solver(x0, **kw)
    return {"x": _np(x), "it": it}


def errors(mesh, spec):
    """The messages of facade calls that must raise ValueError."""
    out = []
    for call in spec["calls"]:
        try:
            facade(mesh, dict(spec, **call))
        except ValueError as e:
            out.append(str(e))
        else:
            out.append(None)
    return out


def layout(mesh, spec):
    """Each leaf of the rank's oracle part: shape and dtype, the bytes of
    the storage behind it, with the part's record."""
    F = parallel.shard_finite_sum(oracle(spec), mesh, spec.get("N"))
    specs = parallel.data_specs(oracle(spec), spec.get("N") or
                                oracle(spec).num_terms)
    leaves = {k: (tuple(v.shape), str(v.dtype)) for k, v in
              F.named_buffers()}
    storage = {k: v.untyped_storage().nbytes() for k, v in
               F.named_buffers()}
    leaves_rows = {k: _np(v) for k, v in F.named_buffers()
                   if k in spec.get("values", ())}
    return dict(leaves=leaves, specs=specs, dp_shard=F.dp_shard,
                num_terms=F.num_terms, values=leaves_rows, storage=storage)


def rebase_resume(mesh, spec):
    """Run the family on the int8 rows for ``steps`` states, resume under
    the f32 rows with ``rebase=True`` (``checkpoint.resume_iterator``),
    and report the first resumed state and the state ``more`` later."""
    from ciao_tpu_torch.checkpoint import resume_iterator

    solver = _solver(mesh, spec)
    x0 = _t(spec["x0"])
    kw = _call_args(mesh, spec)
    kq = dict(kw, F=parallel.shard_finite_sum(oracle(spec).with_storage(
        "int8"), mesh))
    it = iter(solver.iterator(x0, **kq))
    for _ in range(spec["steps"]):
        st = next(it)
    it32 = solver.iterator(x0, **kw)
    res = resume_iterator(it32, st, rebase=True)
    first = next(res)
    last = first
    for _ in range(spec.get("more", 0)):
        last = next(res)
    F32 = kw["F"]
    out = dict(first=fields(first), last=fields(last), int8=fields(st))
    if hasattr(first, "c"):
        out["apply"] = _np(F32.apply_all(first.c))
    else:
        out["apply"] = _np(F32.apply_all(first.s))
    return out


def deep(mesh, spec):
    """``deep_solve_dp`` on the case's problem."""
    kw = _call_args(mesh, spec)
    x, info = parallel.deep_solve_dp(_t(spec["x0"]), kw["F"], kw["g"],
                                     L=kw["L"], N=spec["N"], mesh=mesh,
                                     **spec["kw"])
    return dict(x=_np(x), lmax=info.lmax, polish_steps=info.polish_steps,
                objectives=info.staged.objectives)


def power(mesh, spec):
    """``power_lmax_dp`` at the case's point."""
    from ciao_tpu_torch.parallel.deep import power_lmax_dp

    kw = _call_args(mesh, spec)
    return float(power_lmax_dp(mesh, kw["F"], _t(spec["x"]), spec["seed"],
                               spec["N"], iters=spec["iters"]))


def mesh_info(mesh, spec):
    """The mesh, its refusals, and one all-reduce of each dtype."""
    out = dict(rank=mesh.rank, size=mesh.size, device=str(mesh.device),
               shape=mesh.shape)
    try:
        parallel.make_mesh(n_data=mesh.size + 1, device="cpu")
    except ValueError as e:
        out["n_data_error"] = str(e)
    for dt in (torch.float64, torch.complex128):
        out[str(dt)] = _np(tdp._psum(mesh, torch.ones(3, dtype=dt) *
                                     (mesh.rank + 1)))
    return out


def schedules(mesh, spec):
    """The rank's own draws: round starts, indices, block starts."""
    out = {}
    for sw in (1, 2, 3):
        out[f"round{sw}"] = _np(tdp._local_round_starts(
            spec["seed"], spec["it0"], spec["n_loc"], spec["B"], spec["K"],
            sw, mesh.rank, "cpu"))
        out[f"single{sw}"] = np.array([
            int(tdp.local_block_start(spec["seed"], spec["it0"] + k,
                                      spec["n_loc"], spec["B"], sw,
                                      mesh.rank))
            for k in range(spec["K"])])
        out[f"idx{sw}"] = _np(tdp.local_indices(
            spec["seed"], spec["it0"], spec["n_loc"], spec["B"], sw,
            mesh.rank))
    return out


def single_round(mesh, spec):
    """One DP SAGA local round of K steps on kernel #3's path at D = 1
    beside the single-card coefficient SAGA on the same block starts
    (the multistep driver, on the same kernel path): both states."""
    from ciao_tpu_torch.solvers.saga import SAGACfg, saga_init, saga_run

    N, B, K = spec["N"], spec["B"], spec["K"]
    F = oracle(spec)
    g = prox(spec)
    x0, gamma = _t(spec["x0"]), _t(spec["gamma"])
    starts = _t(spec["starts"])
    cfg = tdp.DPCfg(N=N, D=mesh.size, b_loc=B, sweeping=1, alpha=0.999,
                    block=True, coeff=True, local_steps=K, fused=True,
                    rebase_every=50)
    init, _, run, _ = parallel.build_dp_functions(
        "saga", mesh, parallel.shard_finite_sum(F, mesh), g, cfg)
    dp = run(init(x0, gamma, 0), 1, starts=starts[None])
    scfg = SAGACfg(N=N, sag=False, batch=B, block=True, fused=True,
                   coeff=True)
    sc = saga_run(F, g, saga_init(F, g, x0, gamma, 0, scfg), scfg, K,
                  starts=starts)
    return dict(dp=fields(dp), single=fields(sc))


def solo(mesh, spec):
    """Facade calls on rank 0 alone, a mesh of one rank (D = 1), with
    no collective between processes; the other ranks return []. Every
    rank makes every group, as ``new_group`` needs."""
    groups = [dist.new_group([r]) for r in range(mesh.size)]
    if mesh.rank:
        return []
    one = parallel.make_mesh(group=groups[0], device="cpu")
    return {name: facade(one, dict(spec, **call))
            for name, call in spec["calls"].items()}


def rebase_vr(mesh, spec):
    """``steps`` steps of the family on the int8 rows, then the f32
    rows' rebase: the state's fields before and after, and the exact
    table mean or anchor gradient, from the whole f32 oracle on this
    rank, at the state's anchor point (``anchor``, or the table ``c``)."""
    N = spec["cfg"]["N"]
    whole = oracle(spec)
    cfg = tdp.DPCfg(**spec["cfg"])
    g = prox(spec)
    fns = {k: parallel.build_dp_functions(
        spec["family"], mesh, parallel.shard_finite_sum(F, mesh, N), g, cfg)
        for k, F in (("int8", whole.with_storage("int8")), ("f32", whole))}
    init, _, run, _ = fns["int8"]
    st = run(init(_t(spec["x0"]), _t(spec["gamma"]), spec["seed"],
                  *spec.get("extra", ())), spec["steps"])
    rb = fns["f32"][3](st)
    anchor = spec.get("anchor")
    if anchor is not None:
        want = whole.grad_sum_all(getattr(st, anchor)) / N
    else:
        c = torch.zeros(N, dtype=st.c.dtype)
        c[slice(*mesh.rows(N))] = st.c
        c = tdp._psum(mesh, c)
        want = whole.apply_all(c) / N
    return dict(before=fields(st), after=fields(rb), want=_np(want))


def panoc_trials(mesh, spec):
    """A DPPANOC/DPZeroFPR facade call with every FBE evaluation counted
    on this rank: ``x``, the evaluations, the last state's thrash
    gauge."""
    from ciao_tpu_torch.solvers import panoc

    evals = [0]
    inner = panoc._eval_fbe

    def counted(*a, **k):
        evals[0] += 1
        return inner(*a, **k)

    panoc._eval_fbe = counted
    try:
        solver = _solver(mesh, spec)
        kw = _call_args(mesh, spec)
        st = list(itertools.islice(solver.iterator(_t(spec["x0"]), **kw),
                                   spec["take"]))[-1]
    finally:
        panoc._eval_fbe = inner
    return dict(evals=evals[0], ls_ewma=_np(st.ls_ewma), x=_np(st.x),
                it=st.it)


def deep_pd(mesh, spec):
    """``deep_solve_pd_dp`` on the case's problem."""
    kw = _call_args(mesh, spec)
    x, info = parallel.deep_solve_pd_dp(
        _t(spec["x0"]), kw["F"], h=kw["h"], K=kw["K"], N=spec["N"],
        mesh=mesh, **spec["kw"])
    return dict(x=_np(x), refined=info.refined, certified=info.certified,
                steps=info.steps, lam_hat=info.lam_hat)


# ---------------------------------------------------------------------------
# the tensor-parallel runners: each case names its (D, M) mesh and, where
# it is not every rank, the ranks it takes ("ranks"); every rank makes
# every mesh, in the cases' order, as new_group needs, and a rank outside a
# case's mesh returns None
# ---------------------------------------------------------------------------

_MESHES = {}


def mesh2d(spec):
    """The case's (data, model) mesh, made once for the process."""
    D, M = spec["mesh2d"]
    ranks = tuple(spec.get("ranks", range(D * M)))
    key = (D, M, ranks)
    if key not in _MESHES:
        _MESHES[key] = parallel.make_mesh_2d(D, M, ranks=list(ranks),
                                             device="cpu")
    return _MESHES[key]


def _where(m2) -> dict:
    return dict(d=m2.d, m=m2.m, D=m2.D, M=m2.M)


def _tp_sched(spec, key, m2):
    """The data row's explicit schedule: the ranks of a model group take
    the same one."""
    s = spec.get(key)
    if s is None:
        return None
    s = s[m2.d]
    if isinstance(s, list):
        return [_t(a) for a in s]
    return _t(s)


def _tp_parts(spec, m2):
    """(the rank's oracle block, its terms' columns, x0's columns, the
    first init scalar) of a ``build_tp_functions`` case: F =
    ``ZeroOracle`` with no oracle; the terms g, or the pair (g, h)."""
    N = spec["cfg"]["N"]
    F = (oracle(spec) if spec.get("oracle") is not None
         else ZeroOracle(n_terms=N))
    F = parallel.shard_finite_sum_2d(F, m2, N)
    x0 = _t(spec["x0"])
    n = x0.shape[0]

    def cut(p):
        return parallel.put_specs(p, m2, parallel.model_prox_specs(p, n))

    t = terms(spec)
    g = tuple(cut(p) for p in t[:2]) if isinstance(t, tuple) else cut(t)
    gamma = _t(spec["gamma"])
    if gamma.dim() == 1:
        gamma = gamma[slice(*m2.rows(N))].contiguous()
    return F, g, x0[slice(*m2.cols(n))].contiguous(), gamma


def tp_build(mesh, spec):
    """``build_tp_functions`` from init through ``spec["steps"]`` steps on
    the explicit schedule (``run``, or ``step`` one at a time with
    ``"stepwise"``), then ``rebase`` with ``"rebase"``: the final state's
    fields (the rank's shards)."""
    m2 = mesh2d(spec)
    if m2 is None:
        return None
    F, g, x0, gamma = _tp_parts(spec, m2)
    cfg = parallel.TPCfg(**spec["cfg"])
    init, step, run, rebase = parallel.build_tp_functions(
        spec["family"], m2, F, g, cfg)
    st = init(x0, gamma, spec.get("seed", 0), *spec.get("extra", ()))
    starts, idx = _tp_sched(spec, "starts", m2), _tp_sched(spec, "idx", m2)
    coins = _tp_sched(spec, "coins", m2)
    if spec.get("stepwise"):
        for t in range(spec["steps"]):
            st = step(st, None if starts is None else starts[t],
                      None if idx is None else idx[t],
                      None if coins is None else bool(coins[t]))
    else:
        st = run(st, spec["steps"], starts=starts, idx=idx, coins=coins)
    if spec.get("rebase"):
        st = rebase(st)
    return dict(fields(st), **_where(m2))


def tp_facade(mesh, spec):
    """A TP facade call (``x`` whole, ``it``), or with ``"take": k`` the
    fields of the k'th state of its iterator (the rank's shards)."""
    m2 = mesh2d(spec)
    if m2 is None:
        return None
    solver = getattr(parallel, spec["cls"])(mesh=m2, **spec.get("kw", {}))
    x0 = _t(spec["x0"])
    kw = _call_args(mesh, dict(spec, shard=False))
    if spec.get("shard", False):
        kw["F"] = parallel.shard_finite_sum_2d(kw["F"], m2, spec.get("N"))
    if "take" in spec:
        states = list(itertools.islice(solver.iterator(x0, **kw),
                                       spec["take"]))
        return dict(fields(states[-1]), n_states=len(states), **_where(m2))
    x, it = solver(x0, **kw)
    return dict(x=_np(x), it=it, **_where(m2))


def tp_errors(mesh, spec):
    """The messages of TP facade calls that must raise ValueError."""
    out = []
    for call in spec["calls"]:
        try:
            tp_facade(mesh, dict(spec, **call))
        except ValueError as e:
            out.append(str(e))
        else:
            out.append(None)
    return out


def tp_layout(mesh, spec):
    """The rank's oracle block and prox columns: each leaf's shape, the
    bytes behind it, some values, the block's record."""
    m2 = mesh2d(spec)
    if m2 is None:
        return None
    whole = oracle(spec)
    N = spec.get("N") or whole.num_terms
    F = parallel.shard_finite_sum_2d(whole, m2, N)
    g = prox(spec)
    gp = parallel.put_specs(g, m2, parallel.model_prox_specs(
        g, spec["x0"].shape[0]))
    return dict(
        leaves={k: (tuple(v.shape), str(v.dtype))
                for k, v in F.named_buffers()},
        storage={k: v.untyped_storage().nbytes()
                 for k, v in F.named_buffers()},
        values={k: _np(v) for k, v in F.named_buffers()},
        specs=parallel.data_model_specs(whole, N),
        prox={k: _np(v) for k, v in gp.named_buffers()},
        tp_shard=F.tp_shard, num_terms=F.num_terms, **_where(m2))


def tp_rebase(mesh, spec):
    """Run the facade's iterator on the int8 rows for ``steps`` states,
    resume under the f32 rows with ``rebase=True``: the first resumed
    state, the int8 state, and the f32 block's apply_all of its table."""
    from ciao_tpu_torch.checkpoint import resume_iterator

    m2 = mesh2d(spec)
    if m2 is None:
        return None
    solver = getattr(parallel, spec["cls"])(mesh=m2, **spec.get("kw", {}))
    x0 = _t(spec["x0"])
    kw = _call_args(mesh, dict(spec, shard=False))
    F32 = parallel.shard_finite_sum_2d(kw["F"], m2)
    Fq = parallel.shard_finite_sum_2d(kw["F"].with_storage("int8"), m2)
    st = next(itertools.islice(solver.iterator(x0, **dict(kw, F=Fq)),
                               spec["steps"] - 1, None))
    first = next(resume_iterator(solver.iterator(x0, **dict(kw, F=F32)), st,
                                 rebase=True))
    table = first.c if hasattr(first, "c") else first.s
    return dict(first=fields(first), int8=fields(st),
                apply=_np(F32.apply_all(table)), **_where(m2))


def tp_deep(mesh, spec):
    """``deep_solve_tp`` on the case's problem, and the polish path
    against plain TP FISTA."""
    m2 = mesh2d(spec)
    if m2 is None:
        return None
    kw = _call_args(mesh, dict(spec, shard=False))
    F = parallel.shard_finite_sum_2d(kw["F"], m2)
    x, info = parallel.deep_solve_tp(_t(spec["x0"]), F, kw["g"], L=kw["L"],
                                     N=spec["N"], mesh=m2, **spec["kw"])
    out = dict(x=_np(x), lmax=info.lmax, polish_steps=info.polish_steps,
               objectives=info.staged.objectives, **_where(m2))
    x0 = _t(spec["x0"])
    out["polish"] = _np(parallel.TPForwardBackward(
        mesh=m2, maxit=200, fast=True, polish_chunk=spec["polish_chunk"])(
        x0, F=F, g=kw["g"], L=kw["L"])[0])
    out["fista"] = _np(parallel.TPFISTA(mesh=m2, maxit=200)(
        x0, F=F, g=kw["g"], L=kw["L"])[0])
    return out


def tp_power(mesh, spec):
    """``power_lmax_tp`` at the case's point (its columns)."""
    from ciao_tpu_torch.parallel.deep import power_lmax_tp

    m2 = mesh2d(spec)
    if m2 is None:
        return None
    F = parallel.shard_finite_sum_2d(oracle(spec), m2, spec["N"])
    x = _t(spec["x"])
    return float(power_lmax_tp(m2, F, x[slice(*m2.cols(x.shape[0]))],
                               spec["seed"], spec["N"], iters=spec["iters"]))


def tp_mesh(mesh, spec):
    """The (data, model) mesh: the rank's place and parts, and one sum
    over each of its groups."""
    m2 = mesh2d(spec)
    if m2 is None:
        return None
    from ciao_tpu_torch.parallel import tp

    one = torch.ones(2, dtype=torch.float64) * (mesh.rank + 1)
    return dict(rank=m2.rank, size=m2.size, shape=m2.shape,
                rows=m2.rows(spec["N"]), cols=m2.cols(spec["n"]),
                device=str(m2.device), psum_d=_np(tp._psum_d(m2, one)),
                psum_m=_np(tp._psum_m(m2, one)),
                gather=_np(tp.gather_model(m2, torch.full(
                    (1,), m2.m + 1.0, dtype=torch.float64))),
                **_where(m2))


def tp_vs_single(mesh, spec):
    """A (1, 1) mesh's TPSAGA run beside the single-device SAGA on the
    same block starts, and TPFISTA beside FISTA: both results."""
    from ciao_tpu_torch.solvers import FISTA
    from ciao_tpu_torch.solvers.saga import SAGACfg, saga_init, saga_run

    m2 = mesh2d(spec)
    if m2 is None:
        return None
    N, B = spec["N"], spec["B"]
    F, g = oracle(spec), prox(spec)
    x0, gamma = _t(spec["x0"]), _t(spec["gamma"])
    starts = _t(spec["starts"])
    init, _, run, _ = parallel.build_tp_functions(
        "saga", m2, parallel.shard_finite_sum_2d(F, m2), g,
        parallel.TPCfg(N=N, D=1, M=1, b_loc=B))
    tp = run(init(x0, gamma, 0), len(starts), starts=starts.tolist())
    cfg = SAGACfg(N=N, sag=False, batch=B, block=True, coeff=True)
    sc = saga_run(F, g, saga_init(F, g, x0, gamma, 0, cfg), cfg,
                  len(starts), starts=starts)
    L = _t(spec["L"])
    xt, _ = parallel.TPFISTA(mesh=m2, maxit=200)(x0, F=F, g=g, L=L)
    xs, _ = FISTA(maxit=200)(x0, F=F, g=g, L=L)
    return dict(tp=fields(tp), single=fields(sc), fista_tp=_np(xt),
                fista_single=_np(xs))


_GROUPS = {}


def tp_proshi_vs_dp(mesh, spec):
    """TPProshi on the case's (data, model) mesh beside DPProshi on the
    1-D mesh of ``spec["dp_ranks"]`` (every rank makes its group): the
    TP solution (the rank's blocks, gathered over "model") where the rank
    is in the mesh, the DP one where it is in the group, and with
    ``"take"`` the fields of the TP iterator's first state."""
    m2 = mesh2d(spec)
    ranks = tuple(spec["dp_ranks"])
    if ranks not in _GROUPS:
        _GROUPS[ranks] = (None if len(ranks) == mesh.size
                          else dist.new_group(list(ranks)))
    kw = _call_args(mesh, dict(spec, shard=False))
    x0 = _t(spec["x0"])
    out = {}
    if m2 is not None:
        solver = parallel.TPProshi(mesh=m2, **spec["kw"])
        out.update(tp=_np(solver(x0, **kw)[0]), **_where(m2))
        if spec.get("take"):
            out["first"] = fields(next(iter(solver.iterator(x0, **kw))))
    if dist.get_rank() in ranks:
        one = parallel.make_mesh(group=_GROUPS[ranks], device="cpu")
        out["dp"] = _np(parallel.DPProshi(mesh=one, **spec["kw"])(x0, **kw)[0])
    return out


def tp_run_vs_step(mesh, spec):
    """A family from init through ``spec["steps"]`` steps twice on the
    rank's own draws: one ``run`` call (its draws in one pass) and
    ``step`` calls (each its own draw)."""
    m2 = mesh2d(spec)
    if m2 is None:
        return None
    F, g, x0, gamma = _tp_parts(spec, m2)
    init, step, run, _ = parallel.build_tp_functions(
        spec["family"], m2, F, g, parallel.TPCfg(**spec["cfg"]))
    st0 = init(x0, gamma, spec.get("seed", 0), *spec.get("extra", ()))
    b = st0
    for _ in range(spec["steps"]):
        b = step(b)
    return dict(run=fields(run(st0, spec["steps"])), step=fields(b),
                **_where(m2))


def tp_vs_single_vr(mesh, spec):
    """A (1, 1) mesh's run of a family beside the single-card solver's on
    the same explicit schedule (block starts, inner starts, coins): both
    states."""
    from ciao_tpu_torch.solvers import katyusha as sk
    from ciao_tpu_torch.solvers import lsvrg as sl
    from ciao_tpu_torch.solvers import point_saga as sp
    from ciao_tpu_torch.solvers import sarah as ss
    from ciao_tpu_torch.solvers import ssnm as sm

    m2 = mesh2d(spec)
    if m2 is None:
        return None
    fam, N, B, T = spec["family"], spec["N"], spec["B"], spec["steps"]
    F, g = oracle(spec), prox(spec)
    x0, a = _t(spec["x0"]), _t(spec["gamma"])
    extra = spec.get("extra", ())
    cfg = parallel.TPCfg(**spec["cfg"])
    init, _, run, _ = parallel.build_tp_functions(
        fam, m2, parallel.shard_finite_sum_2d(F, m2), g, cfg)
    starts = spec["starts"]
    coins = spec.get("coins")
    tp = run(init(x0, a, 0, *extra), T, starts=list(starts), coins=coins)
    st = [torch.as_tensor(s_) for s_ in starts]
    if fam == "katyusha":
        c = sk.KatyushaCfg(N=N, batch=B, m=cfg.m_inner, block=True,
                           ns=cfg.variant == "ns")
        one = sk.katyusha_run(F, g, sk.katyusha_init(
            F, g, x0, a, _t(extra[0]), _t(extra[1]), 0, c), c, T, starts=st)
    elif fam == "sarah":
        c = ss.SARAHCfg(N=N, batch=B, m=cfg.m_inner, block=True)
        one = ss.sarah_run(F, g, ss.sarah_init(F, g, x0, a, extra[0], 0, c),
                           c, T, starts=st)
    elif fam == "lsvrg":
        c = sl.LSVRGCfg(N=N, batch=B, block=True)
        one = sl.lsvrg_run(F, g, sl.lsvrg_init(F, g, x0, a, extra[0], 0, c),
                           c, T, starts=torch.stack(st), coins=coins)
    elif fam == "lkatyusha":
        c = sl.LKatyushaCfg(N=N, batch=B, block=True)
        one = sl.lkatyusha_run(F, g, sl.lkatyusha_init(
            F, g, x0, a, *(_t(e) for e in extra[:3]), extra[3], 0, c), c, T,
            starts=torch.stack(st), coins=coins)
    elif fam == "point_saga":
        c = sp.PointSAGACfg(N=N, batch=B, block=True)
        one = sp.point_saga_run(F, Zero(), sp.point_saga_init(
            F, Zero(), x0, a, 0, c), c, T, starts=torch.stack(st))
    else:
        c = sm.SSNMCfg(N=N, batch=B)
        one = sm.ssnm_run(F, g, sm.ssnm_init(F, g, x0, a, _t(extra[0]), 0, c),
                          c, T, starts=torch.stack(st))
    return dict(tp=fields(tp), single=fields(one))


def tp_panoc_trials(mesh, spec):
    """A TPPANOC/TPZeroFPR iterator's first ``take`` states with every FBE
    evaluation counted on this rank: the evaluations, each state's
    envelope value, and the last state's fields."""
    from ciao_tpu_torch.solvers import panoc

    m2 = mesh2d(spec)
    if m2 is None:
        return None
    evals = [0]
    inner = panoc._eval_fbe

    def counted(*a, **k):
        evals[0] += 1
        return inner(*a, **k)

    panoc._eval_fbe = counted
    try:
        solver = getattr(parallel, spec["cls"])(mesh=m2, **spec["kw"])
        kw = _call_args(mesh, dict(spec, shard=False))
        states = list(itertools.islice(solver.iterator(_t(spec["x0"]), **kw),
                                       spec["take"]))
    finally:
        panoc._eval_fbe = inner
    return dict(evals=evals[0], fbe=np.array([float(s_.fbe)
                                              for s_ in states]),
                last=fields(states[-1]), **_where(m2))


def tp_deep_pd(mesh, spec):
    """``deep_solve_pd_tp`` on the case's problem: the whole x, the
    verdicts, the steps and the seconds."""
    m2 = mesh2d(spec)
    if m2 is None:
        return None
    kw = _call_args(mesh, dict(spec, shard=False))
    t0 = time.perf_counter()
    x, info = parallel.deep_solve_pd_tp(
        _t(spec["x0"]), kw["F"], g=kw["g"], h=kw["h"], K=kw["K"],
        N=spec["N"], mesh=m2, **spec["kw"])
    return dict(x=_np(x), refined=info.refined, certified=info.certified,
                steps=info.steps, lam_hat=info.lam_hat,
                seconds=time.perf_counter() - t0, **_where(m2))


def dryrun(mesh, spec):
    """``entry.dryrun_multichip`` over the whole default group on the CPU,
    and its refusal of a size the group is not."""
    from ciao_tpu_torch.entry import dryrun_multichip

    out = {}
    try:
        dryrun_multichip(mesh.size + 1, device="cpu")
    except RuntimeError as e:
        out["refusal"] = str(e)
    t0 = time.perf_counter()
    dryrun_multichip(mesh.size, device="cpu")
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# the sharded checkpoint and the examples
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sub_mesh(mesh, on):
    """The mesh a checkpoint case saves or loads on: the whole default
    group's (``on`` None), a 1-D mesh over the global ranks ``on`` (a
    list), or a (data, model) mesh (``on`` a dict with ``"mesh2d"``).
    Every rank makes the groups, once a process; a rank outside the mesh
    gets None."""
    if on is None:
        return mesh
    if isinstance(on, dict):
        return mesh2d(on)
    key = ("1d", tuple(on))
    if key not in _MESHES:
        group = dist.new_group(list(on))
        _MESHES[key] = (parallel.make_mesh(group=group, device="cpu")
                        if dist.get_rank() in on else None)
    return _MESHES[key]


def _place(m) -> dict:
    if hasattr(m, "M"):
        return _where(m)
    return dict(d=m.rank, m=0, D=m.size, M=1)


def _ckpt_stream(m, spec):
    """The iterator of the case's facade on the mesh ``m``."""
    solver = getattr(parallel, spec["cls"])(mesh=m, **spec.get("kw", {}))
    kw = _call_args(m, dict(spec, shard=not hasattr(m, "M")))
    return solver.iterator(_t(spec["x0"]), **kw)


def ckpt(mesh, spec):
    """Save a facade's state after ``steps`` steps on the mesh
    ``spec["save_on"]`` (``save_async(..., mesh=)``, stepping on
    ``overlap`` states while the write runs; or with ``"gather"``,
    ``save(..., mesh=)``), then restore it with ``load_orbax`` into the
    first state of the same facade on the mesh ``spec["load_on"]`` and
    resume: the saved state, the straight run
    ``more`` steps on from it, the restored state, the resumed one
    ``more`` steps on, and with ``after`` the solution that many steps
    after the restore; each rank's parts with its place."""
    from ciao_tpu_torch import checkpoint

    path = os.path.join(spec["dir"], spec["path"])
    out = {}
    m = sub_mesh(mesh, spec.get("save_on"))
    if m is not None:
        it = _ckpt_stream(m, spec)
        stream = iter(it)
        for _ in range(spec["steps"] + 1):
            st = next(stream)
        if spec.get("gather"):
            checkpoint.save(path, st, mesh=m)
        else:
            mgr = checkpoint.save_async(path, st, mesh=m)
            live = st
            for _ in range(spec.get("overlap", 0)):
                live = it._step_fn(live)
            mgr.wait_until_finished()
        straight = st
        for _ in range(spec["more"]):
            straight = it._step_fn(straight)
        out.update(saved=fields(st), straight=fields(straight),
                   save_at=_place(m))
    dist.barrier()
    m = sub_mesh(mesh, spec.get("load_on", spec.get("save_on")))
    if m is not None:
        it = _ckpt_stream(m, spec)
        like = next(iter(it))
        restored = checkpoint.load_orbax(path, like, mesh=m)
        res = checkpoint.resume_iterator(it, restored)
        first = next(res)
        st = first
        for _ in range(spec["more"]):
            st = next(res)
        out.update(restored=fields(first), resumed=fields(st),
                   load_at=_place(m), like_it=like.it)
        for _ in range(spec.get("after", 0)):
            st = it._step_fn(st)
        if spec.get("after"):
            out["final"] = _np(st.solution)
    dist.barrier()
    return out


def ckpt_errors(mesh, spec):
    """The refusals of the sharded checkpoint on the whole group, each
    case's message (None where nothing was raised): ``save`` and
    ``save_async`` without a mesh; ``save_async`` with a placement table
    that forgets DPSAGA's cut ``s`` (every rank must raise); a restore
    onto a mesh the rows do not divide over; and a template of another
    class."""
    from ciao_tpu_torch import checkpoint
    from ciao_tpu_torch.parallel import placement

    stream = iter(_ckpt_stream(mesh, spec))
    st = next(stream)
    st = next(stream)
    path = os.path.join(spec["dir"], spec["path"])
    out = {}

    def catch(key, fn):
        try:
            fn()
        except ValueError as e:
            out[key] = str(e)
        else:
            out[key] = None

    catch("save", lambda: checkpoint.save(path + ".pt", st))
    catch("save_async", lambda: checkpoint.save_async(path + ".pt", st))
    cut = placement.DP_SPECS[type(st)]
    placement.DP_SPECS[type(st)] = {}
    try:
        catch("forgotten", lambda: checkpoint.save_async(path, st,
                                                         mesh=mesh))
    finally:
        placement.DP_SPECS[type(st)] = cut
    checkpoint.save_async(path, st, mesh=mesh).wait_until_finished()
    three = spec["three"] and sub_mesh(mesh, spec["three"])
    if three:
        like = st._replace(s=st.s[:spec["three_rows"]].clone())
        catch("divide", lambda: checkpoint.load_orbax(path, like,
                                                      mesh=three))
        catch("class", lambda: checkpoint.load_orbax(
            path, parallel.dp.DPFBState(st.gamma, st.gamma, st.z, st.z, 1,
                                        0), mesh=three))
    dist.barrier()
    return out


def example(mesh, spec):
    """An example of ``examples_torch/``: its ``main`` on the rank's CPU,
    in the spawned group (its asserts bite on rank 0)."""
    import importlib.util

    name = spec["name"]
    mspec = importlib.util.spec_from_file_location(
        f"port_ex_{name}", os.path.join(ROOT, "examples_torch",
                                        f"{name}.py"))
    mod = importlib.util.module_from_spec(mspec)
    mspec.loader.exec_module(mod)
    return mod.main(device="cpu")


def multihost(mesh, spec):
    """tests/multihost_worker.py's runs at its global sizes (its eight
    devices' N = 128, n = 32, batch 8) on the group's D ranks: DPSAGA
    lockstep (400 steps) and in local rounds (50 of 8 steps), TPSAGA on a
    (D/2, 2) mesh (400 steps), all f64; then ``deep_solve_dp`` on the f32
    well-conditioned plant, its chunk count pinned (``plateau_rtol=-1``).
    The solutions, the lockstep gap and ``deep_solve_dp``'s rel."""
    from ciao_tpu_torch.utils.problems import make_lasso

    D, batch = mesh.size, 8
    N, n = 16 * batch, 32
    prob = make_lasso(N=N, n=n, p=4, seed=0)
    whole = LeastSquaresRows(_t(prob.A), _t(prob.b), float(N))
    F = parallel.shard_finite_sum(whole, mesh)
    g = NormL1(_t(prob.lam))
    x0 = torch.zeros(n, dtype=torch.float64)
    out = {}
    x, _ = parallel.DPSAGA(mesh=mesh, batch=batch, block_sampling=True,
                           maxit=400)(x0, F=F, g=g, L=prob.L)
    out["lockstep"] = _np(x)
    x, _ = parallel.DPSAGA(mesh=mesh, batch=batch, block_sampling=True,
                           local_steps=8, rebase_every=16, maxit=50)(
        x0, F=F, g=g, L=prob.L)
    out["local"] = _np(x)
    mesh2 = parallel.make_mesh_2d(D // 2, 2, device=mesh.device)
    x, _ = parallel.TPSAGA(mesh=mesh2, batch=batch, maxit=400)(
        x0, F=whole, g=g, L=prob.L)
    out["tp"] = _np(x)
    wc = make_lasso(N=N, n=n, p=4, seed=0, dtype=np.float32,
                    well_conditioned=True)
    F32 = parallel.shard_finite_sum(
        LeastSquaresRows(_t(wc.A), _t(wc.b), float(N)), mesh)
    x, _ = parallel.deep_solve_dp(
        torch.zeros(n), F32, NormL1(float(wc.lam)), L=wc.L, N=N, mesh=mesh,
        batch=batch, local_steps=8, chunk_rounds=32, max_rounds=256,
        plateau_rtol=-1.0, polish_steps=8, polish_chunk=4)
    out["deep"] = _np(x)
    out["gap"] = float(prob.cost(out["lockstep"]) - prob.f_star)
    out["x0_gap"] = float(prob.cost(np.zeros(n)) - prob.f_star)
    out["rel_deep"] = float((wc.cost(out["deep"].astype(np.float64))
                             - wc.f_star) / abs(wc.f_star))
    return out


RUNNERS = dict(build=build, facade=facade, errors=errors, layout=layout,
               rebase_resume=rebase_resume, deep=deep, power=power,
               mesh_info=mesh_info, schedules=schedules,
               single_round=single_round, run_vs_step=run_vs_step,
               solo=solo, rebase_vr=rebase_vr, panoc_trials=panoc_trials,
               deep_pd=deep_pd, tp_build=tp_build, tp_facade=tp_facade,
               tp_errors=tp_errors, tp_layout=tp_layout, tp_rebase=tp_rebase,
               tp_deep=tp_deep, tp_power=tp_power, tp_mesh=tp_mesh,
               tp_vs_single=tp_vs_single, tp_proshi_vs_dp=tp_proshi_vs_dp,
               tp_run_vs_step=tp_run_vs_step, tp_vs_single_vr=tp_vs_single_vr,
               tp_panoc_trials=tp_panoc_trials, tp_deep_pd=tp_deep_pd,
               dryrun=dryrun, ckpt=ckpt, ckpt_errors=ckpt_errors,
               example=example, multihost=multihost)


# ---------------------------------------------------------------------------
# the processes
# ---------------------------------------------------------------------------

def _rank_main(rank, D, store_path, cases_path, out_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, D)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=D,
                            timeout=TIMEOUT)
    try:
        mesh = parallel.make_mesh(device="cpu")
        cases = torch.load(cases_path, weights_only=False)
        out = {"_seconds": {}}
        for name, spec in cases.items():
            t0 = time.perf_counter()
            try:
                out[name] = RUNNERS[spec["fn"]](mesh, spec)
                out["_seconds"][name] = time.perf_counter() - t0
            except Exception:
                # the case's collectives may now be out of step across the
                # ranks: record the error and stop
                out[name] = {"error": traceback.format_exc()}
                break
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(cases: dict, D: int, tmp_path, reverse: bool = False) -> list:
    """Run ``cases`` on D gloo ranks; returns each rank's ``{case name:
    result}`` (a failed case's result is ``{"error": traceback}``, and no
    later case runs). ``reverse`` starts the ranks one by one, the last
    first, in place of ``torch.multiprocessing.start_processes``."""
    tmp = str(tmp_path)
    cases_path = os.path.join(tmp, "cases.pt")
    torch.save(cases, cases_path)
    args = (D, os.path.join(tmp, "store"), cases_path, tmp)
    if reverse:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, args=(r,) + args)
                 for r in reversed(range(D))]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        assert all(p.exitcode == 0 for p in procs), [p.exitcode
                                                     for p in procs]
    else:
        mp.start_processes(_rank_main, args=args, nprocs=D, join=True,
                           start_method="spawn")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(D)]


def result(results, name: str, rank: int = 0):
    """One case's result on one rank; raises with the rank's traceback
    when the case failed there."""
    r = results[rank].get(name)
    if r is None:
        raise AssertionError(f"case {name} did not run on rank {rank} "
                             f"(an earlier case failed)")
    if isinstance(r, dict) and "error" in r:
        raise AssertionError(f"case {name} failed on rank {rank}:\n"
                             f"{r['error']}")
    return r
