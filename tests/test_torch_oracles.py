"""The port's ``LeastSquaresRows`` and problem generator against JAX.

Same numpy inputs through ``ciao_tpu.oracles.LeastSquaresRows`` and
``ciao_tpu_torch.oracles.LeastSquaresRows``: the coefficient protocol in
f32 and f64 with f32, bf16 and int8 row storage, ``quantize_rows`` to
the bit, and ``make_lasso`` to the bit. Matrix products sum in other
orders in the two libraries, so the protocol is held at rtol 1e-5 (f32
iterates) / 1e-12 (f64), with atols scaled by the largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciao_tpu.oracles import LeastSquaresRows as JLeastSquaresRows
from ciao_tpu.oracles.base import quantize_rows as jquantize_rows
from ciao_tpu.utils.problems import make_lasso as jmake_lasso
from ciao_tpu_torch.convert import least_squares_from_numpy, tensor_from_numpy
from ciao_tpu_torch.oracles import (
    LeastSquaresRows, parse_storage_dtype, quantize_rows,
)
from ciao_tpu_torch.utils.problems import make_lasso
from torch_threads import one_torch_thread  # noqa: F401

N, n = 96, 24
TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _close(got, want, dtype):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    scale = float(np.abs(want).max()) + 1e-300
    np.testing.assert_allclose(got, want, rtol=TOL[dtype],
                               atol=TOL[dtype] * scale)


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_rows_bit_equal(seed):
    """Same q and row scales as JAX to the bit: the f32 division, round
    half to even, the clip, and the guard on all-zero rows."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((64, 40)) * rng.uniform(1e-3, 1e3, (64, 1)))
    A = A.astype(np.float32)
    A[3] = 0.0
    A[5, :4] = [127.0, 0.5, 1.5, -2.5]  # rs = 1: exact halves round to even
    A[5, 4:] = 0.0
    jq, jrs = jquantize_rows(jnp.asarray(A))
    tq, trs = quantize_rows(torch.tensor(A))
    assert tq.dtype == torch.int8 and trs.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(trs.numpy().view(np.uint32),
                                  np.asarray(jrs).view(np.uint32))
    assert float(trs[3]) == 1.0 and not tq[3].any()
    np.testing.assert_array_equal(tq[5, :4].numpy(), [127, 0, 2, -2])


def _pair(dtype, storage, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, n)).astype(dtype)
    b = rng.standard_normal(N).astype(dtype)
    JF = JLeastSquaresRows(A=jnp.asarray(A), b=jnp.asarray(b),
                           scale=jnp.asarray(float(N), dtype))
    TF = LeastSquaresRows(torch.tensor(A), torch.tensor(b),
                          torch.tensor(float(N), dtype=torch.from_numpy(
                              A).dtype))
    if storage != "f32":
        JF, TF = JF.with_storage(storage), TF.with_storage(storage)
    return JF, TF, rng


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_coefficient_protocol_matches_jax(dtype, storage):
    """Every oracle method the SAGA slice calls, with row storage f32,
    bf16 or int8: narrow rows widen to the iterate's dtype inside each
    product in both packages, and int8 rows compute with exactly
    diag(rs)·Q."""
    JF, TF, rng = _pair(dtype, storage)
    assert TF.num_terms == JF.num_terms == N and TF.dim == JF.dim == n
    assert TF.A.dtype == {"f32": torch.from_numpy(np.zeros(1, dtype)).dtype,
                          "bf16": torch.bfloat16, "int8": torch.int8}[storage]
    if storage == "int8":
        np.testing.assert_array_equal(TF.A.numpy(), np.asarray(JF.A))
        np.testing.assert_array_equal(TF.row_scale.numpy(),
                                      np.asarray(JF.row_scale))
    x = rng.standard_normal(n).astype(dtype)
    w = rng.standard_normal(N).astype(dtype)
    idx = np.array([3, 17, 41, 95, 0], np.int32)
    jx, jw, tx, tw = (jnp.asarray(x), jnp.asarray(w), torch.tensor(x),
                      torch.tensor(w))
    _close(TF.coeff_all(tx), JF.coeff_all(jx), dtype)
    _close(TF.apply_all(tw), JF.apply_all(jw), dtype)
    _close(TF.coeff_block(tx, 16, 32), JF.coeff_block(jx, 16, 32), dtype)
    # a device start (the solver's case) takes the same rows
    _close(TF.coeff_block(tx, torch.tensor(16), 32),
           JF.coeff_block(jx, 16, 32), dtype)
    _close(TF.apply_rows_block(tw[16:48], 16, 32),
           JF.apply_rows_block(jw[16:48], 16, 32), dtype)
    _close(TF.apply_rows_block(tw[16:48], torch.tensor(16), 32),
           JF.apply_rows_block(jw[16:48], 16, 32), dtype)
    _close(TF.coeff_batch(tx, torch.tensor(idx)),
           JF.coeff_batch(jx, jnp.asarray(idx)), dtype)
    _close(TF.apply_rows(tw[:5], torch.tensor(idx)),
           JF.apply_rows(jw[:5], jnp.asarray(idx)), dtype)
    tv, tg = TF.value_and_grad_all(tx)
    jv, jg = JF.value_and_grad_all(jx)
    _close(tv, jv, dtype)
    _close(tg, jg, dtype)
    rows, offs = TF.coeff_rows_data()
    assert rows is TF.A and offs is TF.b
    assert (TF.coeff_rows_scale() is None) == (storage != "int8")
    assert TF.coeff_mode == 0 and TF.supports_coeff


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_margin_protocol_matches_jax(dtype, storage):
    """The margin protocol of the polish and the staged objective: raw
    margins (int8 scales are applied to the margin, never the rows), the
    coefficient and the loss sum from them, the one-pass value sum and
    the curvature weight, same tolerances as the coefficient protocol."""
    JF, TF, rng = _pair(dtype, storage, seed=2)
    x = rng.standard_normal(n).astype(dtype)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    jm, tm = JF.margin_all(jx), TF.margin_all(tx)
    _close(tm, jm, dtype)
    _close(TF.margin_block(tx, 16, 32), JF.margin_block(jx, 16, 32), dtype)
    _close(TF.coeff_from_margin(tm[16:48], 16, 32),
           JF.coeff_from_margin(jm[16:48], 16, 32), dtype)
    _close(TF.coeff_from_margin_all(tm), JF.coeff_from_margin_all(jm), dtype)
    _close(TF.coeff_from_margin_all(tm), TF.coeff_all(tx).numpy(), dtype)
    _close(TF.value_from_margin_all(tm), JF.value_from_margin_all(jm), dtype)
    _close(TF.value_sum_all(tx), JF.value_sum_all(jx), dtype)
    _close(TF.value_sum_all(tx), TF.value_and_grad_all(tx)[0].sum().numpy(),
           dtype)
    _close(TF.hess_weight_from_margin(tm, 0.5),
           JF.hess_weight_from_margin(jm, 0.5), dtype)


def test_with_storage_rules():
    _, TF, _ = _pair(np.float32, "f32")
    assert TF.with_storage("f32").A.dtype == torch.float32
    assert TF.with_storage(torch.bfloat16).A.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="already int8"):
        TF.with_storage("int8").with_storage("int8")
    with pytest.raises(ValueError, match="unknown storage"):
        parse_storage_dtype("int4")
    assert parse_storage_dtype("i8") is torch.int8
    # complex rows keep a complex storage: int8 raises JAX's error, and a
    # real dtype would drop the imaginary part
    C = LeastSquaresRows(torch.ones(4, 2, dtype=torch.complex64),
                         torch.zeros(4, dtype=torch.complex64), 4.0)
    assert C.scale.dtype == torch.float32
    assert C.with_storage(torch.complex128).A.dtype == torch.complex128
    with pytest.raises(ValueError, match="int8 storage requires real rows"):
        C.with_storage("int8")
    with pytest.raises(ValueError, match="imaginary part"):
        C.with_storage("bf16")


def test_oracle_is_a_module_of_buffers():
    """The oracle's data are buffers, so .to() moves and casts them."""
    _, TF, _ = _pair(np.float64, "int8")
    names = dict(TF.named_buffers())
    assert set(names) == {"A", "b", "scale", "row_scale"}
    assert TF.to("cpu") is TF


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_least_squares_from_numpy(storage):
    """The JAX oracle's fields carried over as numpy arrays give the
    same stored rows, bit for bit, and the same coefficients."""
    JF, _, rng = _pair(np.float32, storage)
    TF = least_squares_from_numpy(
        np.asarray(JF.A), np.asarray(JF.b), np.asarray(JF.scale),
        None if JF.row_scale is None else np.asarray(JF.row_scale))
    assert TF.A.dtype == {"f32": torch.float32, "bf16": torch.bfloat16,
                          "int8": torch.int8}[storage]
    np.testing.assert_array_equal(TF.A.float().numpy(),
                                  np.asarray(JF.A.astype(jnp.float32)))
    x = rng.standard_normal(n).astype(np.float32)
    _close(TF.coeff_all(torch.tensor(x)), JF.coeff_all(jnp.asarray(x)),
           np.float32)
    bf = tensor_from_numpy(np.asarray(jnp.asarray([1.5, -2.0], jnp.bfloat16)))
    assert bf.dtype == torch.bfloat16 and bf.tolist() == [1.5, -2.0]


@pytest.mark.parametrize("kw", [
    dict(N=6, n=3, p=2, seed=0),
    dict(N=256, n=64, p=8, seed=0, dtype=np.float32, well_conditioned=True),
    dict(N=128, n=16, p=3, seed=4, lam=0.5, rho=3.0),
    dict(N=32, n=8, p=2, seed=1, dtype=np.complex64),
], ids=["ref", "well-conditioned-f32", "lam-rho", "c64"])
def test_make_lasso_bit_equal(kw):
    """The port's numpy copy draws the very same problem from a seed."""
    want, got = jmake_lasso(**kw), make_lasso(**kw)
    for field in ("A", "b", "x_star", "L"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.lam == want.lam and got.f_star == want.f_star
    assert got.cost(got.x_star) == want.cost(want.x_star)
