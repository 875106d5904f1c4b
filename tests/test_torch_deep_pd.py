"""The port's primal-dual deep route (``solvers/deep_pd.py``: the
compensated Condat-Vũ driver, ``tv_refine``, ``tv_refine3`` and
``deep_solve_pd``) and its two planted problems against the JAX package
on the CPU.

The plants equal JAX's bit for bit; the compensated driver in f64 is
JAX's and the port's own plain ``pd_run`` within 1e-11; the two
refinements on one f32 iterate give JAX's jump set, verdict and point
(x̂ within 1e-6 of the largest level, v within 1e-3·λ of its f64 value,
as JAX's is); ``deep_solve_pd``
with τ and σ shared with JAX certifies the same jump set, with x within
1e-6 of the largest level; with the port's own spectral τ it meets
``tests/test_deep_pd.py``'s bars (rel ≤ 1e-8, three-term ≤ 1e-9, flat
runs and zeros exact), and the single-device cases of that file hold on
the port. JAX runs as ``tests/test_deep_pd.py`` runs it (x64 on, from
``tests/conftest.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciao_tpu import LeastSquaresRows as JLeastSquaresRows
from ciao_tpu import deep_solve_pd as jdeep_solve_pd
from ciao_tpu import tv_refine as jtv_refine
from ciao_tpu import tv_refine3 as jtv_refine3
from ciao_tpu.ops.linmap import FirstDifference as JFirstDifference
from ciao_tpu.prox import NormL1 as JNormL1
from ciao_tpu.solvers import deep_pd as jdeep_pd
from ciao_tpu.solvers import primal_dual as jpd
from ciao_tpu.utils import problems as jproblems
from ciao_tpu_torch import (
    CondatVu, DeepPDInfo, FirstDifference, LeastSquaresRows, LogisticRows,
    NormL1, deep_solve_pd, tv_refine, tv_refine3,
)
from ciao_tpu_torch.prox import SqrDistPoint
from ciao_tpu_torch.solvers import deep_pd, primal_dual
from ciao_tpu_torch.utils import (
    make_fused_lasso_planted, make_three_term_planted,
)
from torch_threads import one_torch_thread  # noqa: F401


F32 = {"f32": (torch.float32, jnp.float32),
       "f64": (torch.float64, jnp.float64)}


def _oracles(A, b, dtype="f32"):
    """The port's and JAX's least-squares rows of one (A, b), scale N."""
    tdt, jdt = F32[dtype]
    N = A.shape[0]
    return (LeastSquaresRows(torch.tensor(A, dtype=tdt),
                             torch.tensor(b, dtype=tdt), float(N)),
            JLeastSquaresRows(A=jnp.asarray(A, jdt), b=jnp.asarray(b, jdt),
                              scale=jnp.asarray(float(N), jdt)))


def _l1(lam, dtype=torch.float32):
    return NormL1(torch.tensor(lam, dtype=dtype))


def _rel(p, x):
    return (p.cost(np.asarray(x, np.float64)) - p.f_star) / abs(p.f_star)


def _jumps(x):
    return np.nonzero(np.diff(np.asarray(x, np.float64)))[0]


PLANTS = {"fused": (make_fused_lasso_planted,
                    jproblems.make_fused_lasso_planted, 4),
          "three-term": (make_three_term_planted,
                         jproblems.make_three_term_planted, 6)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_plants_equal_jax_bit_for_bit(plant, seed):
    """Both plants draw JAX's arrays bit for bit from one seed: every
    field of the problem equal, and cost equal at a random point."""
    mine, theirs, jumps = PLANTS[plant]
    p = mine(N=512, n=64, jumps=jumps, seed=seed)
    q = theirs(N=512, n=64, jumps=jumps, seed=seed)
    assert type(p).__name__ == type(q).__name__
    assert p._fields == q._fields
    for name in p._fields:
        a, b = getattr(p, name), getattr(q, name)
        assert np.array_equal(a, b), name
        assert np.asarray(a).dtype == np.asarray(b).dtype, name
    x = np.random.default_rng(seed).standard_normal(64)
    assert p.cost(x) == q.cost(x)


def test_planted_construction_is_exact():
    """tests/test_deep_pd.py:44 on the port's plant: the rank-1 dual
    correction meets the fused-lasso KKT system to f64 roundoff, and x*
    is a strict minimum."""
    N, n = 2048, 128
    p = make_fused_lasso_planted(N=N, n=n, jumps=6, seed=0)
    Dt_v = np.zeros(n)
    Dt_v[:-1] -= p.v_star
    Dt_v[1:] += p.v_star
    assert np.max(np.abs(p.A.T @ (p.A @ p.x_star - p.b) + Dt_v)) < 1e-10
    assert abs(p.cost(p.x_star) - p.f_star) < 1e-10
    d = np.diff(p.x_star)
    J = d != 0
    np.testing.assert_array_equal(p.v_star[J], p.lam * np.sign(d[J]))
    assert np.max(np.abs(p.v_star[~J])) <= 0.6 * p.lam + 1e-12
    rng = np.random.default_rng(1)
    for _ in range(8):
        assert p.cost(p.x_star + 1e-3 * rng.standard_normal(n)) > p.f_star


def test_three_term_construction_is_exact():
    """tests/test_deep_pd.py:267 on the port's plant."""
    N, n = 2048, 128
    p = make_three_term_planted(N=N, n=n, jumps=6, seed=0)
    Dt_v = np.zeros(n)
    Dt_v[:-1] -= p.v_star
    Dt_v[1:] += p.v_star
    kkt = p.A.T @ (p.A @ p.x_star - p.b) + p.u_star + Dt_v
    assert np.max(np.abs(kkt)) < 1e-10
    assert abs(p.cost(p.x_star) - p.f_star) < 1e-10
    assert np.sum(p.x_star == 0) > n // 4
    rng = np.random.default_rng(1)
    for _ in range(8):
        assert p.cost(p.x_star + 1e-3 * rng.standard_normal(n)) > p.f_star


def test_pd_run_compensated_matches_jax_and_plain_in_f64():
    """tests/test_deep_pd.py:118: in f64, with τ and σ from the facade's
    setup, 200 compensated steps are JAX's and the port's own plain
    ``pd_run`` within 1e-11 (the compensation is invisible in f64)."""
    N, n = 512, 64
    p = make_fused_lasso_planted(N=N, n=n, jumps=4, seed=0)
    F, JF = _oracles(p.A, p.b, "f64")
    x0, F, g, h, K, cfg, init = CondatVu()._setup(
        torch.zeros(n, dtype=torch.float64), F, None,
        _l1(p.lam, torch.float64), FirstDifference(), p.L, N)
    s_plain = primal_dual.pd_run(F, g, h, K, init(), cfg, 200)
    s_comp = deep_pd.pd_run_compensated(F, g, h, K, init(), cfg, 200, 128)
    _, JF, jg, jh, JK, jcfg, jinit = jpd.CondatVu()._setup(
        jnp.zeros(n, jnp.float64), JF, None,
        JNormL1(lam=jnp.asarray(p.lam, jnp.float64)), JFirstDifference(),
        p.L, N)
    assert float(init().tau) == float(jinit().tau)
    j_comp = jdeep_pd.pd_run_compensated(JF, jg, jh, JK, jinit(), jcfg, 200,
                                         128)
    for got, want in ((s_comp.x, s_plain.x), (s_comp.y, s_plain.y),
                      (s_comp.x, j_comp.x), (s_comp.y, j_comp.y)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-11)


def _iterates(p):
    """A plateaued f32 iterate (x* plus 1e-6 noise on every coordinate,
    which leaves the jump set) and one with a spurious jump."""
    rng = np.random.default_rng(11)
    good = p.x_star + 1e-6 * rng.standard_normal(p.x_star.shape[0])
    J = np.nonzero(np.diff(p.x_star))[0]
    bad = p.x_star.copy()
    bad[(J[0] + 1 + J[1]) // 2:J[1] + 1] += 2.0
    return {"plateaued": good, "spurious": bad}


def _exact_dual(A, b, x, lam):
    """The dual v that ``tv_refine`` recovers, computed in f64 on the f32
    rows both packages solve with: the reduced solution on x's jump set
    (jump_rtol 1e-3), then v = cumsum(Aᵀ(A·Sz − b)) (scale N, so the mean
    gradient is the plain one)."""
    A = np.asarray(A, np.float32).astype(np.float64)
    b = np.asarray(b, np.float32).astype(np.float64)
    d = np.diff(np.asarray(x, np.float64))
    J = np.nonzero(np.abs(d) > 1e-3 * np.max(np.abs(d)))[0]
    seg = np.cumsum(np.isin(np.arange(A.shape[1]), J + 1))
    AS = A @ np.eye(len(J) + 1)[seg]
    s = np.sign(d[J])
    Dk_t_s = np.zeros(len(J) + 1)
    Dk_t_s[:-1] -= s
    Dk_t_s[1:] += s
    z = np.linalg.solve(AS.T @ AS, AS.T @ b - lam * Dk_t_s)
    return np.cumsum((A.T @ (AS @ z - b))[:-1])


@pytest.mark.parametrize("which", ["plateaued", "spurious"])
@pytest.mark.parametrize("dtype", sorted(F32))
def test_tv_refine_matches_jax(dtype, which):
    """One f32 iterate through both packages' ``tv_refine`` (rows f32 or
    f64; the reduced system is f32 in both): the same jump set and
    verdict, x̂ within 1e-6 of the largest level (the iterative refinement
    takes both to the same f64 solution), and each package's v within
    1e-3·λ of the dual computed in f64 on the same f32 rows, so the two
    within 2e-3·λ. Closer is out of reach of either: A·S is an f32
    product whose sums round in another order in XLA and in torch (about
    60 % of its entries differ in the last bit), and the certificate's
    cumulative sum carries that to 3.8-7.3e-4·λ in each, and to 0.6-1.0e-3·λ
    between them (measured on these four cases; the JAX module's comments
    give 0.002λ)."""
    N, n = 4096, 128
    p = make_fused_lasso_planted(N=N, n=n, jumps=6, seed=7)
    F, JF = _oracles(p.A, p.b, dtype)
    x = np.asarray(_iterates(p)[which], np.float32)
    xh, cert, v = tv_refine(F, torch.tensor(x), p.lam, chunk=1024)
    jxh, jcert, jv = jtv_refine(JF, jnp.asarray(x), p.lam, chunk=1024)
    assert cert == jcert == (which == "plateaued")
    assert xh.dtype == torch.float32 and v.shape == (n - 1,)
    np.testing.assert_array_equal(_jumps(xh), _jumps(jxh))
    np.testing.assert_allclose(xh.numpy(), np.asarray(jxh), rtol=0,
                               atol=1e-6 * np.max(np.abs(jxh)))
    v_exact = _exact_dual(p.A, p.b, x, p.lam)
    for got in (v, np.asarray(jv)):
        np.testing.assert_allclose(got, v_exact, rtol=0, atol=1e-3 * p.lam)


@pytest.mark.parametrize("which", ["plateaued", "spurious"])
@pytest.mark.parametrize("dtype", sorted(F32))
def test_tv_refine3_matches_jax(dtype, which):
    """The three-term refinement on one f32 iterate in both packages: the
    same jump set, zero pattern and verdict, x̂ within 1e-6 of the
    largest level."""
    N, n = 4096, 128
    p = make_three_term_planted(N=N, n=n, jumps=6, seed=3)
    F, JF = _oracles(p.A, p.b, dtype)
    x = np.asarray(_iterates(p)[which], np.float32)
    xh, cert = tv_refine3(F, torch.tensor(x), p.lam1, p.lam2, chunk=1024)
    jxh, jcert = jtv_refine3(JF, jnp.asarray(x), p.lam1, p.lam2, chunk=1024)
    assert cert == jcert == (which == "plateaued")
    np.testing.assert_array_equal(_jumps(xh), _jumps(jxh))
    np.testing.assert_array_equal(xh.numpy() == 0, np.asarray(jxh) == 0)
    np.testing.assert_allclose(xh.numpy(), np.asarray(jxh), rtol=0,
                               atol=1e-6 * np.max(np.abs(jxh)))


def _problem(kind, seed):
    """tests/test_deep_pd.py:67's (fused) and :285's (three-term)
    problems: the plant and the (g, h) terms of both packages."""
    N, n = 8192, 256
    if kind == "fused":
        p = make_fused_lasso_planted(N=N, n=n, jumps=8, seed=seed)
        terms = (None, _l1(p.lam)), (None, JNormL1(
            lam=jnp.asarray(p.lam, jnp.float32)))
    else:
        p = make_three_term_planted(N=N, n=n, jumps=9, seed=seed)
        terms = ((_l1(p.lam1), _l1(p.lam2)),
                 (JNormL1(lam=jnp.asarray(p.lam1, jnp.float32)),
                  JNormL1(lam=jnp.asarray(p.lam2, jnp.float32))))
    return p, terms


RUN = dict(chunk=1024, chunk_steps=512, max_steps=32768)


@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize("kind", ["fused", "three-term"])
def test_deep_solve_pd_matches_jax_at_shared_steps(kind, seed):
    """``deep_solve_pd`` in both packages with one explicit τ (1.2·λmax of
    AᵀA in f64, σ = 1/2): both certified, the same jump set and steps,
    x within 1e-6 of the largest level (f32 runs whose sums go in other
    orders, then the same reduced solve)."""
    p, ((g, h), (jg, jh)) = _problem(kind, seed)
    N, n = p.A.shape
    F, JF = _oracles(p.A, p.b)
    lmax = 1.2 * float(np.linalg.eigvalsh(p.A.T @ p.A)[-1])
    tau, sigma = 0.99 / (lmax / 2.0 + 0.5 * 4.0), 0.5
    x, info = deep_solve_pd(torch.zeros(n), F, g=g, h=h, K=FirstDifference(),
                            N=N, tau=tau, sigma=sigma, **RUN)
    jx, jinfo = jdeep_solve_pd(jnp.zeros(n, jnp.float32), JF, g=jg, h=jh,
                               K=JFirstDifference(), N=N, tau=tau,
                               sigma=sigma, **RUN)
    assert isinstance(info, DeepPDInfo) and info.lam_hat is None
    assert info.refined and info.certified
    assert jinfo.refined and jinfo.certified
    assert info.steps == jinfo.steps
    np.testing.assert_array_equal(_jumps(x), _jumps(jx))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-6 * np.max(np.abs(np.asarray(jx))))


@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize("kind", ["fused", "three-term"])
def test_deep_solve_pd_certified_at_its_own_spectral_step(kind, seed):
    """tests/test_deep_pd.py:67 and :285 with the port's spectral τ (its
    power bound starts from its own draw): rel ≤ 1e-8 (three-term ≤
    1e-9) against the exact f64 optimum, the true jumps recovered and
    every flat run (and every planted zero) exact in f32."""
    p, ((g, h), _) = _problem(kind, seed)
    N, n = p.A.shape
    F, _ = _oracles(p.A, p.b)
    x, info = deep_solve_pd(torch.zeros(n), F, g=g, h=h, K=FirstDifference(),
                            N=N, **RUN)
    assert info.refined and info.certified and info.lam_hat > 0
    assert x.device.type == "cpu" and x.dtype == torch.float32
    rel = _rel(p, x)
    assert 0 <= rel < (1e-8 if kind == "fused" else 1e-9)
    xn = x.numpy().astype(np.float64)
    d = np.abs(np.diff(xn))
    true_J = np.abs(np.diff(p.x_star)) > 0
    assert np.all(d[~true_J] == 0.0)
    if kind == "fused":
        assert np.all(d[true_J] > 1e-2)
    else:
        assert np.all(xn[p.x_star == 0] == 0.0)


def test_deep_solve_pd_beats_unrefined_floor():
    """tests/test_deep_pd.py:87: the same budget without the reduced
    solve sits at the first-order TV floor."""
    N, n = 8192, 256
    p = make_fused_lasso_planted(N=N, n=n, jumps=8, seed=1)
    F, _ = _oracles(p.A, p.b)
    kw = dict(N=N, chunk=1024, chunk_steps=512, max_steps=4096)
    x_ref, i_ref = deep_solve_pd(torch.zeros(n), F, h=_l1(p.lam),
                                 K=FirstDifference(), **kw)
    x_raw, i_raw = deep_solve_pd(torch.zeros(n), F, h=_l1(p.lam),
                                 K=FirstDifference(), refine=False, **kw)
    assert i_ref.refined and not i_raw.refined
    assert _rel(p, x_ref) < 1e-8 < _rel(p, x_raw)


def test_tv_refine_rejects_unidentified_iterate():
    """tests/test_deep_pd.py:105: a garbage point fails the certificate."""
    N, n = 2048, 128
    p = make_fused_lasso_planted(N=N, n=n, jumps=6, seed=3)
    F, _ = _oracles(p.A, p.b)
    x_bad = torch.tensor(np.random.default_rng(0).standard_normal(n),
                         dtype=torch.float32)
    _, certified, _ = tv_refine(F, x_bad, p.lam, chunk=1024)
    assert not certified


def test_deep_solve_pd_chambolle_pock_path():
    """tests/test_deep_pd.py:140: F = None takes the plain ``pd_run`` and
    solves a small TV denoise to its subdifferential certificate."""
    rng = np.random.default_rng(3)
    n = 48
    truth = np.repeat([0.0, 2.0, -1.0], n // 3)
    b = torch.tensor(truth + 0.2 * rng.standard_normal(n))
    lam = 0.3
    x, info = deep_solve_pd(
        torch.zeros(n, dtype=torch.float64),
        g=SqrDistPoint(b=b, rho=torch.tensor(1.0, dtype=torch.float64)),
        h=NormL1(torch.tensor(lam, dtype=torch.float64)),
        K=FirstDifference(), N=1, tau=0.25, sigma=1.0, chunk_steps=2000,
        max_steps=40000, plateau_rtol=1e-14)
    assert not info.refined
    xn = x.numpy()
    v = np.cumsum(xn - b.numpy())[:-1]
    d = np.diff(xn)
    J = np.abs(d) > 1e-6
    assert np.max(np.abs(v[~J])) <= lam * (1 + 1e-6)
    np.testing.assert_allclose(v[J], lam * np.sign(d[J]), rtol=0, atol=1e-6)


def test_tv_refine_constant_iterate_no_jumps():
    """tests/test_deep_pd.py:190: k = 1 evaluates and fails honestly."""
    N, n = 2048, 128
    p = make_fused_lasso_planted(N=N, n=n, jumps=6, seed=5)
    F, _ = _oracles(p.A, p.b)
    x_hat, certified, v = tv_refine(F, torch.full((n,), 0.5), p.lam,
                                    chunk=1024)
    assert isinstance(certified, bool) and not certified
    assert x_hat.shape == (n,) and v.shape == (n - 1,)


def test_refinements_refuse_non_lsq_and_int8_rows():
    """tests/test_deep_pd.py:204: both refinements raise for logistic
    rows, and ``deep_solve_pd`` skips the refinement for them; int8 rows
    are refused (their raw values define another operator)."""
    rng = np.random.default_rng(0)
    N, n = 256, 32
    A = torch.tensor(rng.standard_normal((N, n)), dtype=torch.float32)
    F = LogisticRows(A, torch.tensor(np.sign(rng.standard_normal(N)),
                                     dtype=torch.float32))
    with pytest.raises(ValueError, match="LeastSquaresRows"):
        tv_refine(F, torch.zeros(n), 0.1, chunk=64)
    with pytest.raises(ValueError, match="LeastSquaresRows"):
        tv_refine3(F, torch.zeros(n), 0.1, 0.1, chunk=64)
    x, info = deep_solve_pd(torch.zeros(n), F, h=_l1(0.05),
                            K=FirstDifference(), N=N, L=np.full(N, float(N)),
                            tau=1e-3, chunk=64, chunk_steps=64,
                            max_steps=256)
    assert not info.refined and torch.isfinite(x).all()
    Fq = LeastSquaresRows(A, torch.ones(N), float(N)).with_storage("int8")
    for call in (lambda: tv_refine(Fq, torch.zeros(n), 0.1, chunk=64),
                 lambda: tv_refine3(Fq, torch.zeros(n), 0.1, 0.1, chunk=64),
                 lambda: deep_solve_pd(torch.zeros(n), Fq, h=_l1(0.1),
                                       K=FirstDifference(), N=N)):
        with pytest.raises(ValueError, match="int8"):
            call()


def test_tv_refine_certificate_soundness_under_corruption():
    """tests/test_deep_pd.py:224: a dropped jump, a spurious jump and a
    flipped jump sign each fail the certificate; x* itself certifies."""
    N, n = 4096, 128
    p = make_fused_lasso_planted(N=N, n=n, jumps=6, seed=7)
    F, _ = _oracles(p.A, p.b)
    xs = p.x_star.copy()
    J = np.nonzero(np.abs(np.diff(xs)) > 0)[0]
    x_drop = xs.copy()
    x_drop[J[2] + 1:J[3] + 1] = x_drop[J[2]]
    x_spur = xs.copy()
    x_spur[(J[0] + 1 + J[1]) // 2:J[1] + 1] += 2.0
    x_flip = xs.copy()
    lvl_lo, lvl_hi = x_flip[J[1]], x_flip[J[1] + 1]
    x_flip[J[1] + 1:J[2] + 1] = lvl_lo - (lvl_hi - lvl_lo)
    for x_bad in (x_drop, x_spur, x_flip):
        _, certified, _ = tv_refine(
            F, torch.tensor(x_bad, dtype=torch.float32), p.lam, chunk=1024)
        assert not certified
    _, certified, _ = tv_refine(F, torch.tensor(xs, dtype=torch.float32),
                                p.lam, chunk=1024)
    assert certified


def test_tv_refine3_reduces_to_two_term_at_lam1_zero():
    """tests/test_deep_pd.py:309: at λ₁ = 0 the interval certificate is
    the two-term cumsum: the same verdict, the same point within 2e-6."""
    N, n = 4096, 128
    p = make_fused_lasso_planted(N=N, n=n, jumps=6, seed=4)
    F, _ = _oracles(p.A, p.b)
    x_good = torch.tensor(p.x_star, dtype=torch.float32)
    xh2, cert2, _ = tv_refine(F, x_good, p.lam, chunk=1024)
    xh3, cert3 = tv_refine3(F, x_good, 0.0, p.lam, chunk=1024)
    assert cert2 and cert3
    np.testing.assert_allclose(xh3.numpy(), xh2.numpy(), rtol=0, atol=2e-6)


def test_tv_refine3_soundness_under_corruption():
    """tests/test_deep_pd.py:326: a zeroed true nonzero segment and a
    lifted true zero segment fail the three-term certificate; x* passes."""
    N, n = 4096, 128
    p = make_three_term_planted(N=N, n=n, jumps=6, seed=3)
    F, _ = _oracles(p.A, p.b)
    xs = p.x_star.copy()
    nz_mask = xs != 0
    x_zeroed = xs.copy()
    x_zeroed[xs == xs[np.nonzero(nz_mask)[0][0]]] = 0.0
    x_unzeroed = xs.copy()
    first_z = np.nonzero(~nz_mask)[0][0]
    seg_end = first_z
    while seg_end < n and xs[seg_end] == 0:
        seg_end += 1
    x_unzeroed[first_z:seg_end] = 3.0
    for x_bad in (x_zeroed, x_unzeroed):
        _, cert = tv_refine3(F, torch.tensor(x_bad, dtype=torch.float32),
                             p.lam1, p.lam2, chunk=1024)
        assert not cert
    _, cert = tv_refine3(F, torch.tensor(xs, dtype=torch.float32), p.lam1,
                         p.lam2, chunk=1024)
    assert cert
