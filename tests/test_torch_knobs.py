"""The row oracles' ``supports_coeff`` and ``ZeroOracle``'s ``example``
constructor knobs against the JAX package on the CPU.

JAX's five dense row oracles take ``supports_coeff`` as a dataclass field
(default True); with False, ``SAGA(table="auto")`` keeps the full (N, n)
gradient table. The port takes the same argument, keeps it through
``with_storage`` and the ``*_from_numpy`` builders, and routes SAGA the
same way: the full-table runs on JAX's block schedule agree with JAX's to
1e-10 in f64, as ``tests/test_torch_saga_full.py``'s do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciao_tpu.oracles import HuberRows as JHuberRows
from ciao_tpu.oracles import LeastSquaresRows as JLeastSquaresRows
from ciao_tpu.oracles import LogisticRows as JLogisticRows
from ciao_tpu.oracles import PoissonRows as JPoissonRows
from ciao_tpu.oracles import SquaredHingeRows as JSquaredHingeRows
from ciao_tpu.oracles import ZeroOracle as JZeroOracle
from ciao_tpu.prox import NormL1 as JNormL1
from ciao_tpu.solvers import saga as jsaga
from ciao_tpu_torch import SAGA
from ciao_tpu_torch.convert import (
    huber_from_numpy, least_squares_from_numpy, logistic_from_numpy,
    poisson_from_numpy, sqhinge_from_numpy,
)
from ciao_tpu_torch.oracles import (
    HuberRows, LeastSquaresRows, LogisticRows, PoissonRows,
    SquaredHingeRows, ZeroOracle,
)
from ciao_tpu_torch.prox import NormL1
from ciao_tpu_torch.solvers.saga import saga_init, saga_run
from torch_threads import one_torch_thread  # noqa: F401

N, n, B, LAM = 64, 8, 8, 0.05
KINDS = ["lsq", "logistic", "huber", "sqhinge", "poisson"]


def _data(seed=3):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, n)) / np.sqrt(n)
    b = rng.standard_normal(N)
    y = np.sign(rng.standard_normal(N))
    cnt = rng.poisson(2.0, N).astype(np.float64)
    return A, b, y, cnt


def _jax_oracle(kind, supports_coeff):
    """The JAX oracle of ``kind`` on seeded f64 rows, and its moduli L."""
    A, b, y, cnt = _data()
    j = jnp.asarray
    sq = np.sum(A * A, axis=1)
    if kind == "lsq":
        return JLeastSquaresRows(A=j(A), b=j(b), scale=j(float(N)),
                                 supports_coeff=supports_coeff), N * sq
    if kind == "logistic":
        return JLogisticRows(X=j(A), y=j(y),
                             supports_coeff=supports_coeff), 0.25 * sq
    if kind == "huber":
        return JHuberRows(A=j(A), b=j(b), delta=j(0.7), scale=j(float(N)),
                          supports_coeff=supports_coeff), N * sq
    if kind == "sqhinge":
        return JSquaredHingeRows(A=j(A), y=j(y), scale=j(2.0),
                                 supports_coeff=supports_coeff), 2.0 * sq
    return JPoissonRows(A=j(0.3 * A), y=j(cnt), scale=j(1.0),
                        supports_coeff=supports_coeff), np.e * 0.09 * sq


def _port_oracle(JF, kind):
    """The port's oracle with ``JF``'s fields, knob included, built by
    the ``*_from_numpy`` builder of ``kind``."""
    a = np.asarray
    kw = dict(device="cpu", supports_coeff=JF.supports_coeff)
    if kind == "lsq":
        return least_squares_from_numpy(a(JF.A), a(JF.b), a(JF.scale), **kw)
    if kind == "logistic":
        return logistic_from_numpy(a(JF.X), a(JF.y), **kw)
    if kind == "huber":
        return huber_from_numpy(a(JF.A), a(JF.b), a(JF.delta), a(JF.scale),
                                **kw)
    if kind == "sqhinge":
        return sqhinge_from_numpy(a(JF.A), a(JF.y), a(JF.scale), **kw)
    return poisson_from_numpy(a(JF.A), a(JF.y), a(JF.scale), **kw)


@pytest.mark.parametrize("kind", KINDS)
def test_oracle_without_coeff_routes_saga_to_the_full_table_as_jax(kind):
    """``supports_coeff=False``: both facades' ``table="auto"`` take the
    full table (True: the coefficient table), the port's
    ``table="coeff"`` raises its ValueError, and 40 full-table block
    steps on JAX's schedule agree with JAX's (z, av and the (N, n) table
    within 1e-10 in f64)."""
    JF, L = _jax_oracle(kind, False)
    F = _port_oracle(JF, kind)
    assert JF.supports_coeff is False and F.supports_coeff is False
    lam = 0.002 if kind == "poisson" else LAM  # a moving Poisson iterate
    jg = JNormL1(lam=jnp.asarray(lam))
    g = NormL1(torch.tensor(lam, dtype=torch.float64))
    jx0, x0 = jnp.zeros(n), torch.zeros(n, dtype=torch.float64)
    kw = dict(maxit=41, block_sampling=True, batch=B)
    jcfg = jsaga.SAGA(**kw)._setup(jx0, JF, jg, L, N)[3]
    cfg = SAGA(**kw)._setup(x0, F, g, torch.tensor(L), N)[3]
    assert not jcfg.coeff and not cfg.coeff
    JT, _ = _jax_oracle(kind, True)
    assert jsaga.SAGA(**kw)._setup(jx0, JT, jg, L, N)[3].coeff
    assert SAGA(**kw)._setup(x0, _port_oracle(JT, kind), g, torch.tensor(L),
                             N)[3].coeff
    with pytest.raises(ValueError, match="rank-1"):
        SAGA(table="coeff", **kw)._setup(x0, F, g, torch.tensor(L), N)

    steps, gamma = 40, 1.0 / (3.0 * float(np.max(L)))
    key = jax.random.PRNGKey(5)
    starts = np.asarray(jsaga._gen_block_starts(key, 1, jcfg, steps))
    jst = jsaga.saga_run(JF, jg, jsaga.saga_init(JF, jg, jx0,
                                                 jnp.asarray(gamma), key,
                                                 jcfg), jcfg, steps)
    st = saga_run(F, g, saga_init(F, g, x0, gamma, 0, cfg), cfg, steps,
                  starts=torch.tensor(starts))
    assert st.s.shape == (N, n) and st.it == int(jst.it) == steps + 1
    assert float(np.abs(np.asarray(jst.z)).max()) > 0
    for name in ("z", "av", "s"):
        want = np.asarray(getattr(jst, name))
        np.testing.assert_allclose(
            getattr(st, name).numpy(), want, rtol=1e-10,
            atol=1e-10 * float(np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_builders_and_storage_keep_the_knob(kind):
    """The ``*_from_numpy`` builders pass ``supports_coeff`` on (default
    True, as JAX's field), ``with_storage`` keeps it for bf16 and int8
    rows as ``dataclasses.replace`` keeps JAX's, and the constructors
    take it by keyword."""
    for flag in (False, True):
        JF, _ = _jax_oracle(kind, flag)
        F = _port_oracle(JF, kind)
        assert F.supports_coeff is flag
        for storage in ("bf16", "int8"):
            assert F.with_storage(storage).supports_coeff is flag
            assert JF.with_storage(storage).supports_coeff is flag
    A, b, y, _ = _data()
    At, bt, yt = torch.tensor(A), torch.tensor(b), torch.tensor(y)
    built = {"lsq": lambda **k: LeastSquaresRows(At, bt, float(N), **k),
             "logistic": lambda **k: LogisticRows(At, yt, **k),
             "huber": lambda **k: HuberRows(At, bt, 0.7, float(N), **k),
             "sqhinge": lambda **k: SquaredHingeRows(At, yt, 2.0, **k),
             "poisson": lambda **k: PoissonRows(At, yt.abs(), **k)}[kind]
    assert built().supports_coeff is True
    assert built(supports_coeff=False).supports_coeff is False


def test_zero_oracle_takes_example_as_jax():
    """``ZeroOracle(n_terms, example)``: JAX's fields, the example kept
    (and moved with the module), zero values and gradients of the
    example's shape and dtype as JAX's, and a SAGA run with it as F
    gives JAX's iterate: the prox of the start."""
    x = np.linspace(-1.0, 1.0, n)
    JZ = JZeroOracle(n_terms=N, example=jnp.asarray(x))
    Z = ZeroOracle(N, example=torch.tensor(x))
    assert ZeroOracle(N).example is None and JZeroOracle(n_terms=N).example \
        is None
    assert Z.num_terms == JZ.num_terms == N
    np.testing.assert_array_equal(Z.example.numpy(), np.asarray(JZ.example))
    assert ZeroOracle(N, torch.tensor(x)).example.dtype == torch.float64
    assert Z.to("cpu").example is not None
    jv, jgr = JZ.value_and_grad_i(jnp.asarray(x), 3)
    v, gr = Z.value_and_grad_i(torch.tensor(x), 3)
    assert float(v) == float(jv) == 0.0
    np.testing.assert_array_equal(gr.numpy(), np.asarray(jgr))
    np.testing.assert_array_equal(Z.grad_sum_all(torch.tensor(x)).numpy(),
                                  np.asarray(JZ.grad_sum_all(jnp.asarray(x))))
    kw = dict(maxit=9, block_sampling=True, batch=B, gamma=0.5)
    jz, _ = jsaga.SAGA(**kw)(jnp.asarray(x), F=JZ,
                             g=JNormL1(lam=jnp.asarray(LAM)))
    z, _ = SAGA(**kw)(torch.tensor(x), F=Z,
                      g=NormL1(torch.tensor(LAM, dtype=torch.float64)))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-15, atol=0)
