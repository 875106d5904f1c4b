"""The port's ``Zero`` and ``NormL1`` against the JAX package.

Same numpy inputs through ``ciao_tpu.prox`` and ``ciao_tpu_torch.prox``,
in f32 and f64. The soft-threshold is elementwise, so ``prox_only``
agrees to the last bit; ``value`` is a sum whose order may differ
between the libraries, so it is held at rtol 1e-6 (f32) / 1e-14 (f64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciao_tpu.prox import NormL1 as JNormL1
from ciao_tpu.prox import Zero as JZero
from ciao_tpu_torch.prox import NormL1, ProxOperator, Zero
from torch_threads import one_torch_thread  # noqa: F401

DTYPES = [np.float32, np.float64]
RTOL = {np.float32: 1e-6, np.float64: 1e-14}


def _x(dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal(257).astype(dtype)
    x[:4] = [0.0, 0.3, -0.3, 0.29999]
    return x


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("lam", [0.1, 1.0])
def test_norm_l1_matches_jax(dtype, lam):
    x = _x(dtype)
    gamma = 0.3
    jg, tg = JNormL1(lam=lam), NormL1(lam)
    jz, jv = jg.prox(jnp.asarray(x), gamma)
    tz, tv = tg.prox(torch.tensor(x), gamma)
    assert tz.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tg.prox_only(torch.tensor(x), gamma).numpy(),
                                  np.asarray(jg.prox_only(jnp.asarray(x),
                                                          gamma)))
    np.testing.assert_allclose(float(tv), float(jv), rtol=RTOL[dtype])
    np.testing.assert_allclose(float(tg.value(torch.tensor(x))),
                               float(jg.value(jnp.asarray(x))),
                               rtol=RTOL[dtype])
    assert float(tg(torch.tensor(x))) == float(tg.value(torch.tensor(x)))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_norm_l1_tensor_gamma_and_lam(dtype):
    """A tensor stepsize and a tensor lam (the solver's case) give the
    JAX result with jnp scalars of the same dtype."""
    x = _x(dtype, seed=1)
    gamma = np.asarray(0.05, dtype)
    lam = np.asarray(2.0, dtype)
    want = JNormL1(lam=jnp.asarray(lam)).prox_only(jnp.asarray(x),
                                                   jnp.asarray(gamma))
    got = NormL1(torch.tensor(lam)).prox_only(torch.tensor(x),
                                              torch.tensor(gamma))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_zero_matches_jax(dtype):
    x = _x(dtype)
    jz, jv = JZero().prox(jnp.asarray(x), 0.5)
    tz, tv = Zero().prox(torch.tensor(x), 0.5)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    assert float(tv) == float(jv) == 0.0
    assert tv.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(Zero().prox_only(torch.tensor(x), 0.5),
                                  np.asarray(JZero().prox_only(
                                      jnp.asarray(x), 0.5)))


def test_prox_modules_move_with_to():
    """Proxes are modules: lam is a buffer and follows .to()."""
    g = NormL1(0.5)
    assert isinstance(g, ProxOperator) and isinstance(g, torch.nn.Module)
    assert dict(g.named_buffers())["lam"].dtype == torch.float64
    g2 = g.to(torch.float32)
    assert g2.lam.dtype == torch.float32 and float(g2.lam) == 0.5


# ---------------------------------------------------------------------------
# the rest of the library: every operator of ciao_tpu.prox against JAX's
# ---------------------------------------------------------------------------

_R = np.random.default_rng(7)
_X = _R.standard_normal(24) * 1.5
_X[:3] = [0.0, 0.05, -0.05]
_M = _R.standard_normal((6, 4))
_AFF = _R.standard_normal((3, 24))
_LAB = np.sign(_R.standard_normal(24))

# name: (constructor keyword arguments, input); parameters are f64 arrays
# for both packages, inputs f64 (the matrix operators take a matrix)
PROX_CASES = {
    "NormL2": (dict(lam=0.7), _X),
    "SqrNormL2": (dict(lam=0.7), _X),
    "ElasticNet": (dict(lam=0.3, mu=0.8), _X),
    "IndBallL2": (dict(r=2.0), _X),
    "IndSimplex": (dict(a=1.5), _X),
    "NormNuclear": (dict(lam=0.4), _M),
    "GroupNormL21": (dict(lam=0.6, groups=2), _X),
    "NormL0": (dict(lam=0.2), _X),
    "SqrDistPoint": (dict(b=_R.standard_normal(24), rho=1.7), _X),
    "NormL21": (dict(lam=0.5, axis=0), _M),
    "IndBallL1": (dict(r=3.0), _X),
    "NormLinf": (dict(lam=0.9), _X),
    "IndNonnegative": ({}, _X),
    "IndNonpositive": ({}, _X),
    "IndBallLinf": (dict(r=0.8), _X),
    "IndHalfspace": (dict(a=_R.standard_normal(24), b=0.3), _X),
    "IndPoint": (dict(p=_R.standard_normal(24)), _X),
    "IndAffine": (dict(A=_AFF, b=_R.standard_normal(3)), _X),
    "IndSphereL2": (dict(r=2.5), _X),
    "LogBarrier": (dict(mu=0.4), np.abs(_X) + 0.1),
    "HingeLoss": (dict(y=_LAB, mu=0.7), _X),
    "MCP": (dict(lam=0.5, beta=3.0), _X),
    "SCAD": (dict(lam=0.5, a=3.7), _X),
}


def _jax_param(v):
    return jnp.asarray(v) if isinstance(v, np.ndarray) else jnp.asarray(
        v, jnp.float64)


def _torch_param(v):
    if isinstance(v, np.ndarray):
        return torch.tensor(v)
    return v if isinstance(v, int) else torch.tensor(v, dtype=torch.float64)


@pytest.mark.parametrize("name", list(PROX_CASES))
def test_prox_library_matches_jax(name):
    """Every operator of ciao_tpu.prox beyond Zero/NormL1/IndBox against
    JAX's on the same f64 inputs: value at the input, prox (z and g(z)) at
    γ = 0.3 as a Python number and at γ = 1.1 as a 0-d tensor, and the
    ``separable`` flag. Elementwise and sort-based operators agree to the
    last bit up to the sum order of their norms: rtol 1e-12, atol 1e-14
    (the nuclear norm's SVD comes from two LAPACK calls: 1e-10)."""
    import ciao_tpu.prox as jprox
    import ciao_tpu_torch.prox as tprox

    kwargs, x = PROX_CASES[name]
    groups = {"groups", "axis"}
    jop = getattr(jprox, name)(**{k: v if k in groups else _jax_param(v)
                                  for k, v in kwargs.items()})
    top = getattr(tprox, name)(**{k: v if k in groups else _torch_param(v)
                                  for k, v in kwargs.items()})
    assert top.separable == jop.separable
    tol = dict(rtol=1e-10 if name == "NormNuclear" else 1e-12, atol=1e-14)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    np.testing.assert_allclose(float(top.value(tx)), float(jop.value(jx)),
                               **tol)
    for gamma_j, gamma_t in ((0.3, 0.3),
                             (jnp.asarray(1.1), torch.tensor(1.1,
                                                             dtype=torch.float64))):
        jz, jv = jop.prox(jx, gamma_j)
        tz, tv = top.prox(tx, gamma_t)
        assert tz.dtype == torch.float64 and tz.shape == tuple(jz.shape)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **tol)
        np.testing.assert_allclose(float(tv), float(jv), **tol)
        np.testing.assert_allclose(top.prox_only(tx, gamma_t).numpy(),
                                   np.asarray(jop.prox_only(jx, gamma_j)),
                                   **tol)


def test_prox_library_moves_and_keeps_dtypes():
    """The new operators are modules: parameters are buffers that follow
    .to(), and f32 inputs give f32 outputs."""
    from ciao_tpu_torch.prox import HingeLoss, IndHalfspace, SqrDistPoint

    x = torch.tensor(_X, dtype=torch.float32)
    for op in (SqrDistPoint(torch.tensor(_X), 2.0),
               IndHalfspace(torch.tensor(_X), 0.5),
               HingeLoss(torch.tensor(_LAB), 0.3)):
        assert all(b.dtype == torch.float64 for b in op.buffers())
        z = op.prox_only(x, 0.5)
        assert z.dtype == torch.float32
        assert op.to(torch.float32).prox_only(x, 0.5).dtype == torch.float32
