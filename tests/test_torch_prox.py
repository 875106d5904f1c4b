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
