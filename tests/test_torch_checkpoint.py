"""The port's checkpoints against the JAX package's checkpoint tests.

Ports of ``tests/test_aux.py:33,44,64,210`` (round trip, exact resume,
the rebase hook and its refusal, the async round trip) and of the
checkpoint cases of ``test_katyusha.py:135``, ``test_lsvrg.py:133``,
``test_sarah.py:135``, ``test_ssnm.py:129``, ``test_point_saga.py:91`` and
``test_primal_dual.py:386``, on the port's own file format. Where JAX
holds a resume to 1e-12, the port's is bit-exact (``torch.equal``): its
steps are pure functions of the state, its draws of (seed, it). One
parametrised test stops, saves, loads and resumes every facade's
iterator, a complex state included. Against JAX: the int8-stage SAGA
state of ``test_aux.py:64``, carried over with
``convert.saga_state_from_numpy`` and resumed with ``rebase=True``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ciao_tpu
from ciao_tpu.oracles import LeastSquaresRows as JLeastSquaresRows
from ciao_tpu.prox import NormL1 as JNormL1
from ciao_tpu.solvers.base import loop as jloop
from ciao_tpu.solvers.base import take as jtake
from ciao_tpu_torch import (
    FISTA, LSVRG, PANOC, SAG, SAGA, SARAH, SSNM, SVRG, CondatVu, DavisYin,
    Finito, FirstDifference, IndBox, Katyusha, LKatyusha, LeastSquaresRows,
    NormL1, PointSAGA, Proshi, ZeroFPR, checkpoint,
)
from ciao_tpu_torch.convert import saga_state_from_numpy
from ciao_tpu_torch.solvers import loop, take
from ciao_tpu_torch.utils.problems import make_lasso
from torch_threads import one_torch_thread  # noqa: F401


def _leaves(node, path="state"):
    """(path, value) of every tensor and scalar of a state, in order."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        for f, v in zip(node._fields, node):
            yield from _leaves(v, f"{path}.{f}")
    elif isinstance(node, (tuple, list)):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, node


def _assert_same(a, b):
    """Two states equal field for field: same classes, tensors bit for bit
    with one dtype, scalars and None equal."""
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    assert type(a) is type(b)
    for (p, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor), p
            assert x.dtype == y.dtype and x.shape == y.shape, p
            assert torch.equal(x, y), p
        else:
            assert type(x) is type(y) and x == y, p


@pytest.fixture(scope="module")
def lasso():
    """tests/test_aux.py's fixture: make_lasso(16, 4, p=2, seed=0), f64."""
    prob = make_lasso(N=16, n=4, p=2, seed=0)
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b), 16.0)
    return prob, F, NormL1(prob.lam)


def _split_resume(tmp_path, make_iter, total, k):
    """(straight, resumed): ``total`` states straight through, and ``k``
    states, a save, a load and ``total − k + 1`` resumed states."""
    straight = loop(take(iter(make_iter()), total))
    mid = loop(take(iter(make_iter()), k))
    checkpoint.save(tmp_path / "mid.pt", mid)
    restored = checkpoint.load(tmp_path / "mid.pt", device="cpu")
    _assert_same(restored, mid)
    resumed = loop(take(checkpoint.resume_iterator(make_iter(), restored),
                        total - k + 1))
    return straight, resumed


# ---------------------------------------------------------------------------
# tests/test_aux.py
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path, lasso):
    """test_aux.py:33: every field of a SAGA state comes back."""
    prob, F, g = lasso
    it = SAGA(maxit=50).iterator(torch.zeros(4, dtype=torch.float64), F=F,
                                 g=g, L=prob.L)
    state = loop(take(iter(it), 20))
    checkpoint.save(tmp_path / "st.pt", state)
    _assert_same(checkpoint.load(tmp_path / "st.pt"), state)


def test_checkpoint_resume_continues_exactly(tmp_path, lasso):
    """test_aux.py:44: stop at 20, save, resume 20 more: the straight
    run's state, bit for bit (JAX: 1e-12)."""
    prob, F, g = lasso
    solver = SAGA(maxit=100)
    straight, resumed = _split_resume(
        tmp_path, lambda: solver.iterator(torch.zeros(4, dtype=torch.float64),
                                          F=F, g=g, L=prob.L), 40, 20)
    _assert_same(resumed, straight)
    assert resumed.it == straight.it == 40


def test_resume_iterator_rebase_storage_switch(lasso):
    """test_aux.py:64: an int8-stage state resumed under f32 rows with
    ``rebase=True`` has av = F.apply_all(s)/N; without it av is kept; an
    iterable with no hook raises."""
    prob, F, g = lasso
    solver = SAGA(maxit=100)
    x0 = torch.zeros(4, dtype=torch.float64)
    Fq = F.with_storage("int8")
    st = loop(take(iter(solver.iterator(x0, F=Fq, g=g, L=prob.L)), 30))
    it_f32 = solver.iterator(x0, F=F, g=g, L=prob.L)
    first = next(checkpoint.resume_iterator(it_f32, st, rebase=True))
    np.testing.assert_allclose(first.av.numpy(),
                               (F.apply_all(st.s) / 16).numpy(),
                               rtol=1e-12, atol=1e-14)
    first_nr = next(checkpoint.resume_iterator(it_f32, st))
    assert torch.equal(first_nr.av, st.av)
    assert float((first.av - st.av).abs().max()) > 0

    class NoHook:
        pass

    with pytest.raises(ValueError, match="rebase"):
        next(checkpoint.resume_iterator(NoHook(), st, rebase=True))


def test_checkpoint_async_roundtrip(tmp_path, lasso):
    """test_aux.py:210: save_async, wait, load_like into the state's own
    structure: every field back, bit for bit. The state is written in
    place after save_async returns; the file keeps the snapshot."""
    prob, F, g = lasso
    state = loop(take(iter(SAGA(maxit=30).iterator(
        torch.zeros(4, dtype=torch.float64), F=F, g=g, L=prob.L)), 10))
    keep = checkpoint.load(_save(tmp_path / "ref.pt", state), device="cpu")
    mgr = checkpoint.save_async(tmp_path / "ck.pt", state)
    state.z.add_(1.0)
    state.s.mul_(2.0)
    mgr.wait_until_finished()
    assert mgr.done()
    _assert_same(checkpoint.load_like(tmp_path / "ck.pt", keep), keep)
    _assert_same(checkpoint.load(tmp_path / "ck.pt", device="cpu"), keep)


def _save(path, state):
    checkpoint.save(path, state)
    return path


# ---------------------------------------------------------------------------
# the families' checkpoint tests
# ---------------------------------------------------------------------------

Nf, nf = 64, 8


@pytest.fixture(scope="module")
def family_lasso():
    """The families' tests' planted Lasso (N = 64, n = 8, f64)."""
    prob = make_lasso(N=Nf, n=nf, p=3, seed=3)
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b),
                         float(Nf))
    return prob, F, NormL1(prob.lam)


@pytest.mark.parametrize("solver,field", [
    (Katyusha(maxit=40), "x_tilde"), (SARAH(maxit=40), "x_tilde"),
    (LSVRG(maxit=40), "w")],
    ids=["katyusha:135", "sarah:135", "lsvrg:133"])
def test_family_checkpoint_resume(tmp_path, family_lasso, solver, field):
    """test_katyusha.py:135, test_sarah.py:135, test_lsvrg.py:133: stop
    at 5, save, resume 5 more: the straight run's 10th state (JAX holds
    ``field`` to 1e-12; here every field, bit for bit)."""
    prob, F, g = family_lasso
    x0 = torch.zeros(nf, dtype=torch.float64)
    straight, resumed = _split_resume(
        tmp_path, lambda: solver.iterator(x0, F=F, g=g, L=prob.L, N=Nf),
        10, 5)
    _assert_same(resumed, straight)
    assert getattr(resumed, field).shape == (nf,)


def test_lsvrg_rebase_recomputes_mu(tmp_path, family_lasso):
    """test_lsvrg.py:133's rebase half: μ at the current anchor under the
    new storage, av = ∇Σf(w)/N to 1e-13."""
    from ciao_tpu_torch.solvers.lsvrg import LSVRGCfg, lsvrg_rebase

    prob, F, g = family_lasso
    x0 = torch.zeros(nf, dtype=torch.float64)
    st = loop(take(iter(LSVRG(maxit=40).iterator(x0, F=F, g=g, L=prob.L,
                                                  N=Nf)), 5))
    st_rb = lsvrg_rebase(F, g, st, LSVRGCfg(N=Nf, batch=1, block=False))
    np.testing.assert_allclose(st_rb.av.numpy(),
                               (F.grad_sum_all(st.z) / Nf).numpy(),
                               rtol=1e-13)


def test_ssnm_rebase_under_int8(family_lasso):
    """test_ssnm.py:129: a state resumed under int8 rows with
    ``rebase=True`` has gbar = F_q.apply_all(c)/N."""
    prob, F, g = family_lasso
    states = list(take(iter(SSNM(batch=4).iterator(
        torch.zeros(nf, dtype=torch.float64), F=F, g=g, L=prob.L)), 3))
    Fq = F.with_storage("int8")
    itq = SSNM(batch=4).iterator(torch.zeros(nf, dtype=torch.float64),
                                 F=Fq, g=g, L=prob.L)
    first = next(checkpoint.resume_iterator(itq, states[-1], rebase=True))
    np.testing.assert_allclose(first.gbar.numpy(),
                               (Fq.apply_all(states[-1].c) / Nf).numpy(),
                               rtol=1e-6, atol=1e-8)


def test_point_saga_checkpoint_resume(tmp_path, family_lasso):
    """test_point_saga.py:91: resume at 5 of 10 equals the straight run."""
    prob, F, _ = family_lasso
    solver = PointSAGA(maxit=40)
    x0 = torch.zeros(nf, dtype=torch.float64)
    straight, resumed = _split_resume(
        tmp_path, lambda: solver.iterator(x0, F=F, L=prob.L, N=Nf), 10, 5)
    _assert_same(resumed, straight)


def test_cv_checkpoint_resume_continues_exactly(tmp_path):
    """test_primal_dual.py:386: Condat-Vũ's primal and dual carry over."""
    prob = make_lasso(N=16, n=8, p=3, seed=0)
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b), 16.0)
    kwargs = dict(F=F, g=NormL1(prob.lam), h=NormL1(0.05),
                  K=FirstDifference(), L=prob.L, N=16)
    solver = CondatVu(maxit=100)
    x0 = torch.zeros(8, dtype=torch.float64)
    straight, resumed = _split_resume(
        tmp_path, lambda: solver.iterator(x0, **kwargs), 40, 20)
    _assert_same(resumed, straight)


# ---------------------------------------------------------------------------
# every facade's iterator
# ---------------------------------------------------------------------------

Nc, nc, Bc = 256, 16, 32


def _facades():
    """(id, solver, extra keywords) of every facade's iterator."""
    bs = dict(block_sampling=True, batch=Bc)
    return [
        ("saga", SAGA(**bs), {}),
        ("sag", SAG(**bs), {}),
        ("saga-full", SAGA(table="full", **bs), {}),
        ("svrg", SVRG(m=Nc // Bc, gamma=3e-5, **bs), {}),
        ("svrg++", SVRG(m=1, gamma=3e-5, plus=True, **bs), {}),
        ("fista", FISTA(), {}),
        ("finito", Finito(sweeping=3, minibatch=(True, Bc)), {}),
        ("finito-full", Finito(sweeping=3, minibatch=(True, Bc),
                               table="full"), {}),
        ("lfinito", Finito(sweeping=3, minibatch=(True, Bc), LFinito=True),
         {}),
        ("finito-adaptive", Finito(adaptive=True), {}),
        ("proshi", Proshi(sweeping=2, minibatch=(True, Bc)),
         dict(g=IndBox(-float("inf"), 1.0))),
        ("katyusha", Katyusha(batch=Bc, block_sampling=True), {}),
        ("sarah", SARAH(batch=Bc, block_sampling=True), {}),
        ("lsvrg", LSVRG(batch=Bc, block_sampling=True), {}),
        ("lkatyusha", LKatyusha(batch=Bc, block_sampling=True), {}),
        ("ssnm", SSNM(batch=Bc), {}),
        ("point-saga", PointSAGA(batch=Bc, block_sampling=True),
         dict(g=None)),
        ("panoc", PANOC(), {}),
        ("zerofpr", ZeroFPR(), {}),
        ("davis-yin", DavisYin(), dict(h=IndBox(-1.0, 1.0))),
        ("condat-vu", CondatVu(), dict(h=NormL1(0.05),
                                       K=FirstDifference())),
    ]


FACADES = _facades()


@pytest.fixture(scope="module")
def facade_lasso():
    prob = make_lasso(N=Nc, n=nc, p=4, seed=1, well_conditioned=True)
    return prob


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128],
                         ids=["f64", "c128"])
@pytest.mark.parametrize("name,solver,extra", FACADES,
                         ids=[f[0] for f in FACADES])
def test_every_facade_resumes_bit_exact(tmp_path, facade_lasso, name,
                                        solver, extra, dtype):
    """Each facade's iterator: 12 states straight, and 6, a save, a load
    and 7 resumed: equal field for field, bit for bit. Complex rows and
    iterates where the facade takes them (SAGA; ProShI, Finito's full
    table and LFinito, SAG, SVRG++ and the adaptive variant are run real
    only, as JAX's complex tests run them)."""
    complex_ok = name in ("saga", "svrg", "fista", "finito", "katyusha",
                          "sarah", "lsvrg", "lkatyusha", "ssnm",
                          "point-saga", "panoc", "zerofpr",
                          "condat-vu")
    if dtype.is_complex and not complex_ok:
        dtype = torch.float64
    prob = facade_lasso
    A = torch.tensor(prob.A, dtype=dtype)
    if dtype.is_complex:
        A = A + 1j * torch.tensor(np.random.default_rng(5).standard_normal(
            prob.A.shape) * 0.1)
    F = LeastSquaresRows(A, torch.tensor(prob.b, dtype=dtype), float(Nc))
    L = (Nc * (A.abs() ** 2).sum(dim=1)).numpy()
    kw = dict(F=F, g=NormL1(prob.lam), L=L, N=Nc)
    kw.update(extra)
    x0 = torch.zeros(nc, dtype=dtype)
    straight, resumed = _split_resume(
        tmp_path, lambda: solver.iterator(x0, **kw), 12, 6)
    _assert_same(resumed, straight)
    assert resumed.it == straight.it


# ---------------------------------------------------------------------------
# the file
# ---------------------------------------------------------------------------

def test_file_reads_with_weights_only(tmp_path, lasso):
    """The file is plain data: torch.load(weights_only=True) reads it."""
    prob, F, g = lasso
    state = loop(take(iter(SAGA(maxit=20).iterator(
        torch.zeros(4, dtype=torch.float64), F=F, g=g, L=prob.L)), 5))
    checkpoint.save(tmp_path / "st.pt", state)
    obj = torch.load(tmp_path / "st.pt", weights_only=True)
    assert obj["format"] == checkpoint.FORMAT
    assert obj["state"]["class"] == "ciao_tpu_torch.solvers.saga:SAGAState"
    assert obj["state"]["fields"] == list(state._fields)


@pytest.mark.parametrize("cls", [
    "ciao_tpu.solvers.saga:SAGAState", "collections:OrderedDict",
    "ciao_tpu_torchx.saga:SAGAState", "ciao_tpu_torch.solvers.saga:SAGACfg",
    "ciao_tpu_torch.solvers.saga:NoSuchState"])
def test_load_refuses_other_classes(tmp_path, cls):
    """load rebuilds NamedTuples of ciao_tpu_torch with the stored fields,
    and refuses any other class with ValueError."""
    torch.save({"format": checkpoint.FORMAT, "state": {
        "kind": "namedtuple", "class": cls, "fields": ["s", "z"],
        "values": [torch.zeros(2), torch.zeros(2)]}}, tmp_path / "x.pt")
    with pytest.raises(ValueError):
        checkpoint.load(tmp_path / "x.pt", device="cpu")


def test_load_places_every_leaf(tmp_path, lasso):
    """load(device=...) puts every tensor on the device asked for
    (``meta`` here: the CPU has no other), and load_like takes the
    template's dtypes and devices."""
    prob, F, g = lasso
    state = loop(take(iter(SAGA(maxit=20, block_sampling=True,
                                batch=4).iterator(
        torch.zeros(4, dtype=torch.float64), F=F, g=g, L=prob.L)), 5))
    checkpoint.save(tmp_path / "st.pt", state)
    meta = checkpoint.load(tmp_path / "st.pt", device="meta")
    tensors = [v for _, v in _leaves(meta) if isinstance(v, torch.Tensor)]
    assert tensors and all(t.device.type == "meta" for t in tensors)
    like = state._replace(z=state.z.float(), av=state.av.float())
    back = checkpoint.load_like(tmp_path / "st.pt", like)
    assert back.z.dtype == back.av.dtype == torch.float32
    assert torch.equal(back.z, state.z.float())
    with pytest.raises(ValueError):
        checkpoint.load_like(tmp_path / "st.pt",
                             state._replace(z=torch.zeros(5)))


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------

def test_jax_int8_state_rebases_onto_port_f32_rows():
    """test_aux.py:64's run in JAX (SAGA on int8 rows, 30 states), its
    state carried over with ``convert.saga_state_from_numpy`` and resumed
    under the port's f32 rows with ``rebase=True``: the first av equals
    JAX's F.apply_all(st.s)/N to 1e-12."""
    prob = make_lasso(N=16, n=4, p=2, seed=0)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                           scale=jnp.asarray(16.0))
    jg = JNormL1(lam=jnp.asarray(prob.lam))
    jst = jloop(jtake(iter(ciao_tpu.SAGA(maxit=100).iterator(
        jnp.zeros(4), F=JF.with_storage("int8"), g=jg, L=prob.L)), 30))
    want = np.asarray(JF.apply_all(jst.s) / 16)
    st = saga_state_from_numpy(np.asarray(jst.s), np.asarray(jst.z),
                               np.asarray(jst.av), np.asarray(jst.gamma),
                               int(jst.it), device="cpu")
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b), 16.0)
    it = SAGA(maxit=100).iterator(torch.zeros(4, dtype=torch.float64), F=F,
                                  g=NormL1(prob.lam), L=prob.L)
    first = next(checkpoint.resume_iterator(it, st, rebase=True))
    np.testing.assert_allclose(first.av.numpy(), want, rtol=1e-12,
                               atol=1e-14)
