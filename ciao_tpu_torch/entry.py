"""Driver entry points (counterpart of ``__graft_entry__.py``).

``entry(device=None)`` — the flagship fused step: one launch window (8
steps) of streamed-table coefficient SAGA on a planted Lasso, which on
the card is one launch of ``saga_coeff_multistep_streamed`` (kernel #4).

``dryrun_multichip(n_devices, device=None)`` — called by every process of
an initialized default process group of ``n_devices`` ranks: one init and
a few steps (or a solve) of every data-parallel family and, for an even
count, every tensor-parallel family on a (n/2, 2) mesh, with the deep
plans, on tiny shapes (N = 8·n, n = 16, f32), each result's shape
asserted.

    python -m ciao_tpu_torch.entry              # entry() on the card
    python -m ciao_tpu_torch.entry cpu          # on the CPU (plain versions)
    python -m ciao_tpu_torch.entry dryrun 2     # 2 ranks on the card (gloo)
    python -m ciao_tpu_torch.entry dryrun 4 cpu # 4 gloo ranks on the CPU
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ciao_tpu_torch import runtime


def _lasso_setup(N, n, dtype, device):
    """``__graft_entry__.py``'s problem: ``make_lasso(N, n, p=max(2,
    n // 8), seed=0)`` as a ``LeastSquaresRows`` of ``dtype`` on
    ``device`` with scale N, ``NormL1(λ)``, L and a zero x0."""
    from ciao_tpu_torch.oracles import LeastSquaresRows
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.utils.problems import make_lasso

    prob = make_lasso(N=N, n=n, p=max(2, n // 8), seed=0, dtype=dtype)
    tdt = torch.from_numpy(np.zeros(0, dtype)).dtype
    F = LeastSquaresRows(torch.tensor(prob.A, dtype=tdt, device=device),
                         torch.tensor(prob.b, dtype=tdt, device=device),
                         float(N))
    g = NormL1(float(prob.lam)).to(device)
    L = torch.tensor(prob.L, dtype=tdt, device=device)
    x0 = torch.zeros(n, dtype=tdt, device=device)
    return prob, F, g, L, x0


def entry(device=None):
    """(fn, args): ``fn(F, g, state)`` runs 8 steps of streamed-table
    coefficient SAGA (``SAGACfg(..., fused_stream=True)``) at N = 8,192,
    n = 128, B = 128 (d = 64 blocks) in f32, γ = 1/(3·max L): one launch
    of kernel #4 on the card, its plain version on the CPU. Runs on the
    card unless ``device`` names another device; with no card and no
    device it raises ``RuntimeError``."""
    from ciao_tpu_torch.solvers.saga import SAGACfg, saga_init, saga_run

    dev = runtime.entry_device(device)
    N, n, batch = 8_192, 128, 128
    _, F, g, L, x0 = _lasso_setup(N, n, np.float32, dev)
    gamma = 1.0 / (3.0 * torch.max(L))
    cfg = SAGACfg(N=N, sag=False, batch=batch, block=True, coeff=True,
                  fused_stream=True)
    state = saga_init(F, g, x0, gamma, 0, cfg)

    def fn(F, g, state):
        return saga_run(F, g, state, cfg, 8)

    return fn, (F, g, state)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One init and a few steps of every advertised DP and TP family
    (with ``deep_solve_dp``, ``deep_solve_pd_dp``, ``deep_solve_tp`` and
    ``deep_solve_pd_tp``) on the ``n_devices`` ranks of the default
    process group, which every one of them calls: ``__graft_entry__.py``'s
    body on its shapes. ``device`` is the ranks' device (the card by
    default, local rank modulo the cards; "cpu" for the CPU). Raises
    ``RuntimeError`` unless the default group is initialized with
    ``n_devices`` ranks, as JAX's raises on too few devices."""
    import torch.distributed as dist

    from ciao_tpu_torch import parallel

    have = (dist.get_world_size() if dist.is_available()
            and dist.is_initialized() else 0)
    if have != n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}): the default process group has "
            f"{have} ranks; start {n_devices} processes and call "
            "torch.distributed.init_process_group in each first")
    mesh = parallel.make_mesh(device=device)
    _dryrun_dp(n_devices, mesh)
    if n_devices % 2 == 0:
        _dryrun_tp(n_devices, device)


def _dryrun_problem(n_devices: int, dev):
    N, n = 8 * n_devices, 16
    _, F, g, L, x0 = _lasso_setup(N, n, np.float32, dev)
    return N, n, F, g, L, x0


def _dryrun_dp(n_devices: int, mesh) -> None:
    """The data-parallel half of the dryrun (``__graft_entry__.py:110-
    324``)."""
    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.ops.linmap import FirstDifference
    from ciao_tpu_torch.parallel.dp import _local_gamma
    from ciao_tpu_torch.prox import IndBox, SqrDistPoint
    from ciao_tpu_torch.solvers.base import resolve_gamma_array

    dev = mesh.device
    D = n_devices
    N, n, F, g, L, x0 = _dryrun_problem(n_devices, dev)
    Fd = parallel.shard_finite_sum(F, mesh)
    gamma = _local_gamma(resolve_gamma_array(None, L, N, 0.999,
                                             torch.float32, dev), mesh, N)
    init, step, _, _ = parallel.build_dp_functions(
        "finito", mesh, Fd, g, parallel.DPCfg(N=N, D=D, b_loc=1, sweeping=1,
                                              alpha=0.999))
    st = step(init(x0, gamma, 0))
    assert st.s.shape == (N // D, n) and st.it == 2

    def shape(solver, want=(n,), **kw):
        x, _ = solver(x0, **dict(dict(F=Fd, g=g, L=L), **kw))
        assert tuple(x.shape) == want, (type(solver).__name__, x.shape)

    shape(parallel.DPSAGA(mesh=mesh, maxit=2, batch=D, block_sampling=True,
                          local_steps=2))
    shape(parallel.DPFinito(mesh=mesh, maxit=2, batch=D, sweeping=2,
                            local_steps=2))
    shape(parallel.DPFinito(mesh=mesh, maxit=2, batch=D, sweeping=2,
                            LFinito=True, local_sweep=True))
    shape(parallel.DPFinito(mesh=mesh, maxit=2, adaptive=True, sweeping=2),
          L=None)
    shape(parallel.DPSVRG(mesh=mesh, maxit=2, batch=D, m=3, local_inner=True))
    for li in (False, True):
        shape(parallel.DPKatyusha(mesh=mesh, maxit=2, batch=D, m=3,
                                  local_inner=li))
        shape(parallel.DPSARAH(mesh=mesh, maxit=2, batch=D, m=3,
                               local_inner=li))
    shape(parallel.DPLSVRG(mesh=mesh, maxit=3, batch=D))
    shape(parallel.DPLKatyusha(mesh=mesh, maxit=3, batch=D))
    shape(parallel.DPPointSAGA(mesh=mesh, maxit=2, batch=D), g=None)
    shape(parallel.DPFISTA(mesh=mesh, maxit=2))
    shape(parallel.DPPANOC(mesh=mesh, maxit=3))
    shape(parallel.DPZeroFPR(mesh=mesh, maxit=3))
    shape(parallel.DPDavisYin(mesh=mesh, maxit=3), h=IndBox(-1.0, 1.0))
    shape(parallel.DPCondatVu(mesh=mesh, maxit=3), h=g, K=FirstDifference())
    g0 = SqrDistPoint(torch.linspace(-1.0, 1.0, n, device=dev), 1.0)
    shape(parallel.DPDouglasRachford(mesh=mesh, maxit=3), F=None, g=g0, h=g,
          L=None, N=N)
    shape(parallel.DPChambollePock(mesh=mesh, maxit=3), F=None, g=g0, h=g,
          K=FirstDifference(), L=None, N=N)
    shape(parallel.DPForwardBackward(mesh=mesh, maxit=2, fast=True,
                                     polish_chunk=4))
    xds, _ = parallel.deep_solve_dp(x0, Fd, g, L=L, N=N, mesh=mesh,
                                    local_steps=2, chunk_rounds=2,
                                    max_rounds=4, polish_steps=2,
                                    polish_chunk=4)
    assert tuple(xds.shape) == (n,)
    xpd, _ = parallel.deep_solve_pd_dp(
        x0, Fd, g=None, h=g, K=FirstDifference(), L=L, N=N, mesh=mesh,
        tau=1e-3, sigma=0.5, chunk_steps=2, max_steps=2, polish_chunk=4)
    assert tuple(xpd.shape) == (n,)
    shape(parallel.DPSSNM(mesh=mesh, maxit=3, batch=D))
    # ProShI: each rank's (N/D, n) block solutions
    shape(parallel.DPProshi(mesh=mesh, maxit=2, batch=D), want=(N // D, n))
    shape(parallel.DPProshi(mesh=mesh, maxit=2, batch=D, sweeping=2,
                            local_steps=2), want=(N // D, n))


def _dryrun_tp(n_devices: int, device) -> None:
    """The tensor-parallel half (``__graft_entry__.py:326-472``): every TP
    family on a (n/2, 2) mesh, TPProshi on a ``DiagQuadratic`` sharing
    plant, ``deep_solve_tp`` and ``deep_solve_pd_tp``."""
    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.oracles import DiagQuadratic
    from ciao_tpu_torch.ops.linmap import FirstDifference
    from ciao_tpu_torch.prox import IndBox, SqrDistPoint

    mesh2 = parallel.make_mesh_2d(n_devices // 2, 2, device=device)
    dev = mesh2.device
    N, n, F, g, L, x0 = _dryrun_problem(n_devices, dev)
    F2 = parallel.shard_finite_sum_2d(F, mesh2)

    def shape(solver, want=(n,), **kw):
        x, _ = solver(x0, **dict(dict(F=F2, g=g, L=L), **kw))
        assert tuple(x.shape) == want, (type(solver).__name__, x.shape)

    for solver in (
            parallel.TPSAGA(mesh=mesh2, maxit=2, batch=2),
            parallel.TPFinito(mesh=mesh2, maxit=2, batch=2, sweeping=3),
            parallel.TPLFinito(mesh=mesh2, maxit=2, batch=2, sweeping=3),
            parallel.TPSVRG(mesh=mesh2, maxit=2, batch=2, m=3),
            parallel.TPKatyusha(mesh=mesh2, maxit=2, batch=2, m=3),
            parallel.TPSARAH(mesh=mesh2, maxit=2, batch=2, m=3),
            parallel.TPLSVRG(mesh=mesh2, maxit=3, batch=2),
            parallel.TPLKatyusha(mesh=mesh2, maxit=3, batch=2),
            parallel.TPFISTA(mesh=mesh2, maxit=2),
            parallel.TPPANOC(mesh=mesh2, maxit=3),
            parallel.TPZeroFPR(mesh=mesh2, maxit=3),
            parallel.TPSSNM(mesh=mesh2, maxit=3, batch=2)):
        shape(solver)
    shape(parallel.TPPointSAGA(mesh=mesh2, maxit=2, batch=2), g=None)
    shape(parallel.TPDavisYin(mesh=mesh2, maxit=3), h=IndBox(-1.0, 1.0))
    g0 = SqrDistPoint(torch.linspace(-1.0, 1.0, n, device=dev), 1.0)
    shape(parallel.TPDouglasRachford(mesh=mesh2, maxit=3), F=None, g=g0, h=g,
          L=None, N=N)
    xdt, _ = parallel.deep_solve_tp(x0, F2, g, L=L, N=N, mesh=mesh2, batch=2,
                                    chunk_steps=8, max_steps=16,
                                    polish_steps=2, polish_chunk=2)
    assert tuple(xdt.shape) == (n,)
    shape(parallel.TPCondatVu(mesh=mesh2, maxit=3), h=g, K=FirstDifference())
    shape(parallel.TPChambollePock(mesh=mesh2, maxit=3), F=None, h=g,
          K=FirstDifference(), L=None, N=N)
    xpt, _ = parallel.deep_solve_pd_tp(
        x0, F2, g=None, h=g, K=FirstDifference(), L=L, N=N, mesh=mesh2,
        tau=1e-3, sigma=0.5, chunk_steps=2, max_steps=2, refine_chunk=4)
    assert tuple(xpt.shape) == (n,)
    Fs = parallel.shard_finite_sum_2d(
        DiagQuadratic(torch.ones(N, n, device=dev),
                      torch.ones(N, n, device=dev)), mesh2)
    xs, _ = parallel.TPProshi(mesh=mesh2, maxit=2, batch=n_devices,
                              sweeping=2)(
        x0, F=Fs, g=IndBox(-float("inf"), torch.ones(n, device=dev)),
        L=torch.ones(N, device=dev), N=N)
    assert tuple(xs.shape) == (N // mesh2.D, n)


def _dryrun_rank(rank: int, size: int, store: str, device) -> None:
    """One rank of ``python -m ciao_tpu_torch.entry dryrun``: gloo over a
    FileStore (CUDA tensors on the card, where NCCL refuses two ranks on
    one device)."""
    import datetime

    import torch.distributed as dist

    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", store=dist.FileStore(store, size),
                            rank=rank, world_size=size,
                            timeout=datetime.timedelta(minutes=5))
    try:
        dryrun_multichip(size, device)
        if device != "cpu":
            torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()


def dryrun_spawn(size: int, device=None) -> None:
    """``size`` rank processes of :func:`dryrun_multichip` over gloo, on the
    CPU (``device="cpu"``) or the card (default; with no card it raises
    ``RuntimeError``)."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    if device is None:
        runtime.entry_device(None)  # raises with no card
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_dryrun_rank, args=(size, os.path.join(
            tmp, "store"), device), nprocs=size, join=True,
            start_method="spawn")


def main(argv) -> int:
    device = "cpu" if "cpu" in argv else None
    if argv and argv[0] == "dryrun":
        size = int(argv[1])
        dryrun_spawn(size, device)
        print(f"dryrun_multichip({size}): ok")
        return 0
    fn, args = entry(device)
    out = fn(*args)
    if out.z.is_cuda:
        torch.cuda.synchronize()
    print("entry: ok, it =", int(out.it))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
