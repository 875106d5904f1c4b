"""The port's entry point and examples against the JAX package's.

Ports of ``tests/test_examples.py:40-61``: each example of
``examples_torch/`` runs its ``small`` shapes on the CPU through the code
path the card takes (the kernel gates closed, or the kernels' plain
versions), its asserts biting. ``entry()``'s step equals eight stepwise
SAGA steps on the same draws. Where both packages get one problem (the
examples that draw with numpy), the port is held to JAX's run of the same
example: ``deep_accuracy`` and ``fused_lasso_tv`` meet their bars in both
and their solutions agree, ``fused_lasso_tv``'s jump sets are equal,
``tv_denoise_2d``'s images agree, and ``sparse_logistic``'s two oracles
agree at a point. The examples that draw with ``jax.random`` draw from a
``torch.Generator`` in the port (a listed deviation), so they are held to
their own asserts alone.
"""

import ast
import importlib.util
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciao_tpu_torch.oracles import least_squares
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ("deep_accuracy", "large_scale_lasso", "lasso_10m",
            "fused_lasso_tv", "tv_denoise_2d", "sparse_logistic")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _port(name):
    return _load(ROOT / "examples_torch" / f"{name}.py", f"port_ex_{name}")


def _jax(name):
    return _load(ROOT / "examples" / f"{name}.py", f"jax_ex_{name}")


# ---------------------------------------------------------------------------
# the examples at their small shapes, asserts and all
# ---------------------------------------------------------------------------

def test_example_deep_accuracy_small_matches_jax():
    """The port meets the 1e-6 bar; JAX's ``deep_solve`` on the same
    problem (the JAX example's call) meets it too; the two solutions agree
    to 2e-6 of max|x*| (1.0e-7 on the CPU)."""
    import ciao_tpu
    from ciao_tpu import LeastSquaresRows as JLS, NormL1 as JN1
    from ciao_tpu.utils.problems import make_lasso as jmake

    rel = _port("deep_accuracy").main(small=True, device="cpu")
    assert rel <= 1e-6
    N, n, batch = 4_096, 128, 256
    prob = jmake(N=N, n=n, p=16, seed=0, dtype=np.float32,
                 well_conditioned=True)
    JF = JLS(A=jnp.asarray(prob.A, jnp.float32),
             b=jnp.asarray(prob.b, jnp.float32),
             scale=jnp.asarray(float(N), jnp.float32))
    jx, _ = ciao_tpu.deep_solve(
        jnp.zeros(n, jnp.float32), JF,
        JN1(lam=jnp.asarray(prob.lam, jnp.float32)), L=prob.L, N=N,
        batch=batch, chunk_epochs=8, max_epochs=128, plateau_rtol=1e-4)
    jx = np.asarray(jx, np.float64)
    assert (prob.cost(jx) - prob.f_star) / abs(prob.f_star) <= 1e-6
    # the port's solution, from the same call the example makes
    import ciao_tpu_torch
    from ciao_tpu_torch.utils.problems import make_lasso

    pprob = make_lasso(N=N, n=n, p=16, seed=0, dtype=np.float32,
                       well_conditioned=True)
    assert np.array_equal(pprob.A, prob.A)
    x, _ = ciao_tpu_torch.deep_solve(
        torch.zeros(n), ciao_tpu_torch.LeastSquaresRows(
            torch.tensor(pprob.A), torch.tensor(pprob.b), float(N)),
        ciao_tpu_torch.NormL1(float(pprob.lam)), L=pprob.L, N=N,
        batch=batch, chunk_epochs=8, max_epochs=128, plateau_rtol=1e-4)
    np.testing.assert_allclose(x.double().numpy(), jx, rtol=0,
                               atol=2e-6 * np.abs(prob.x_star).max())


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_example_large_scale_lasso_small(storage):
    """tests/test_examples.py:52: LFinito decreases the objective."""
    out = _port("large_scale_lasso").main(storage=storage, small=True,
                                          device="cpu")
    assert out["objective"] < out["objective0"]


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_example_lasso_10m_small(storage):
    """tests/test_examples.py:48 (and int8 rows): LFinito decreases the
    objective on the 100-of-128-column rows."""
    out = _port("lasso_10m").main(storage=storage, small=True, device="cpu")
    assert out["objective"] < out["objective0"]


def test_example_fused_lasso_tv_small_matches_jax():
    """The port refines, certifies, meets rel < 1e-7 and keeps flat runs
    exactly flat (the example's asserts); JAX's ``deep_solve_pd`` on the
    same plant does too; the solutions agree to 1e-6 of max|x*| (6.6e-8
    on the CPU) and their jump sets are equal."""
    import ciao_tpu
    from ciao_tpu import FirstDifference as JFD
    from ciao_tpu import LeastSquaresRows as JLS, NormL1 as JN1
    from ciao_tpu.utils import make_fused_lasso_planted as jplant

    rel, x, info = _port("fused_lasso_tv").main(small=True, device="cpu")
    assert info.refined and info.certified and rel < 1e-7
    N, n, jumps = 4_096, 128, 6
    prob = jplant(N=N, n=n, jumps=jumps, seed=0)
    JF = JLS(A=jnp.asarray(prob.A, jnp.float32),
             b=jnp.asarray(prob.b, jnp.float32),
             scale=jnp.asarray(float(N), jnp.float32))
    jx, jinfo = ciao_tpu.deep_solve_pd(
        jnp.zeros(n, jnp.float32), JF,
        h=JN1(lam=jnp.asarray(prob.lam, jnp.float32)), K=JFD(), N=N,
        chunk=4096, chunk_steps=256, max_steps=16_384)
    jx = np.asarray(jx, np.float64)
    assert jinfo.refined and jinfo.certified
    assert (prob.cost(jx) - prob.f_star) / abs(prob.f_star) < 1e-7
    np.testing.assert_allclose(x, jx, rtol=0,
                               atol=1e-6 * np.abs(prob.x_star).max())
    jumps_port = np.diff(x.astype(np.float64)) != 0
    assert np.array_equal(jumps_port, np.diff(jx) != 0)
    assert np.array_equal(jumps_port, np.diff(prob.x_star) != 0)


def test_example_tv_denoise_2d_small_matches_jax():
    """Both TV models denoise (the example's asserts), and each image
    agrees with the JAX example's to 1e-5 of its range (1.4e-7 on the
    CPU): one phantom, one noise draw, 2,000 Chambolle-Pock steps."""
    port = _port("tv_denoise_2d").main(small=True, device="cpu")
    ref = _jax("tv_denoise_2d").main(small=True)
    for tag in ("isotropic", "anisotropic"):
        span = float(ref[tag].max() - ref[tag].min())
        np.testing.assert_allclose(port[tag], ref[tag], rtol=0,
                                   atol=1e-5 * span, err_msg=tag)


def test_example_sparse_logistic_small_matches_jax():
    """The example runs (SAGA and Katyusha lower the objective), and its
    ``build`` gives the JAX example's problem: the objective at x0 = 0 is
    log 2, the two oracles' value sums at a point agree to 1e-6
    (8e-8 on the CPU), their gradient sums to 1e-6 of the largest entry
    (2.7e-7) and the moduli L exactly."""
    ps = _port("sparse_logistic")
    out = ps.main(small=True, device="cpu")
    assert out["saga"] < out["objective0"]
    assert out["katyusha"] < out["objective0"]
    N, n = 4_096, 1_024
    F, L, _ = ps.build(N, n, 16, 4, device="cpu")
    JF, JL, _ = _jax("sparse_logistic").build(N, n, 16, 4)
    assert abs(ps.objective(F, torch.zeros(n), N) - np.log(2.0)) < 1e-6
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32) * 0.1
    v = float(F.value_sum_all(torch.tensor(x)))
    jv = float(JF.value_sum_all(jnp.asarray(x)))
    assert abs(v - jv) <= 1e-6 * abs(jv)
    gs = F.grad_sum_all(torch.tensor(x)).numpy()
    jgs = np.asarray(JF.grad_sum_all(jnp.asarray(x)))
    np.testing.assert_allclose(gs, jgs, rtol=0,
                               atol=1e-6 * np.abs(jgs).max())
    np.testing.assert_array_equal(L.numpy(), np.asarray(JL))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def test_entry_is_eight_stepwise_saga_steps():
    """``entry()``'s fn equals eight stepwise SAGA steps (the same (seed,
    it) draws) to 1e-6 of the largest entry; its problem is
    ``__graft_entry__._lasso_setup``'s, built from the same ``make_lasso``
    arrays."""
    from ciao_tpu_torch.entry import _lasso_setup, entry
    from ciao_tpu_torch.solvers.saga import SAGACfg, saga_run

    fn, (F, g, state) = entry(device="cpu")
    out = fn(F, g, state)
    assert out.it == state.it + 8
    cfg = SAGACfg(N=8_192, sag=False, batch=128, block=True, coeff=True)
    ref = saga_run(F, g, state, cfg, 8)
    for f in ("z", "av", "s"):
        a, b = getattr(out, f), getattr(ref, f)
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max()), f
    jprob, JF, *_ = _load(ROOT / "__graft_entry__.py",
                          "graft_entry")._lasso_setup(8_192, 128, 128,
                                                      np.float32)
    prob = _lasso_setup(8_192, 128, np.float32, "cpu")[0]
    np.testing.assert_array_equal(np.asarray(JF.A), F.A.numpy())
    np.testing.assert_array_equal(np.asarray(JF.b), F.b.numpy())
    assert prob.lam == jprob.lam


def test_entry_main_prints_its_step_count(capsys):
    """``python -m ciao_tpu_torch.entry cpu`` prints JAX's line."""
    from ciao_tpu_torch.entry import main

    assert main(["cpu"]) == 0
    assert capsys.readouterr().out.strip() == "entry: ok, it = 9"


@pytest.mark.parametrize("name", ("entry",) + EXAMPLES)
def test_entry_points_refuse_the_cpu_unasked(name, monkeypatch):
    """With no card and no device named, ``entry()`` and each example's
    ``main`` raise RuntimeError before any work; they never fall back to
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if name == "entry":
        from ciao_tpu_torch.entry import entry as fn
    else:
        fn = _port(name).main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn()


# ---------------------------------------------------------------------------
# the narrow rows' chunked widening, and the imports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["int8", "bf16"])
def test_narrow_rows_widen_in_chunks(storage, monkeypatch):
    """A full pass over narrow rows above _WIDEN_CHUNK_ENTRIES widens them a
    chunk at a time: margins, value and gradient sums equal the one-chunk
    pass to 1e-6 of their largest entry."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    gen = torch.Generator().manual_seed(0)
    A = torch.randn(1_000, 64, generator=gen)
    F = LeastSquaresRows(A, torch.randn(1_000, generator=gen),
                         1_000.0).with_storage(storage)
    x = torch.randn(64, generator=gen)

    def passes():
        return (F.margin_all(x), F.grad_sum_all(x),
                *F.value_sum_and_grad_sum_all(x))

    whole = passes()
    monkeypatch.setattr(least_squares, "_WIDEN_CHUNK_ENTRIES", 64 * 300)
    assert len(list(F._row_chunks(x.dtype))) == 4
    for a, b in zip(passes(), whole):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


IMPORT_FILES = tuple(f"examples_torch/{e}.py" for e in EXAMPLES) + (
    "ciao_tpu_torch/entry.py", "ciao_tpu_torch/checkpoint/__init__.py")


@pytest.mark.parametrize("path", IMPORT_FILES)
def test_entry_points_import_no_jax(path):
    """The examples, the entry point and the checkpoints name no ``jax``
    and nothing of ``ciao_tpu`` in any import, at the top or inside a
    function."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "ciao_tpu"), (
                path, name)


# ---------------------------------------------------------------------------
# the examples that run data-parallel, on two gloo ranks
# ---------------------------------------------------------------------------

# tests/test_examples.py:28, :32, :36, and the multi-process template
PARALLEL_EXAMPLES = ("robust_regression", "poisson_glm",
                     "nonconvex_sparse_mcp", "multihost")


@pytest.fixture(scope="module")
def parallel_runs(tmp_path_factory):
    """Each parallel example's ``main(device="cpu")`` at its defaults on
    two gloo ranks (``tests/torch_parallel_worker.py``'s spawn): the
    template's 30,000 lockstep steps in one group, the other three in
    another beside it, and those three once more on one rank in a third.
    Rank 0 prints and asserts. ``{(name, ranks): [each rank's result]}``."""
    import threading

    import torch_parallel_worker as tw

    groups = ((PARALLEL_EXAMPLES[:3], 2), (PARALLEL_EXAMPLES[3:], 2),
              (PARALLEL_EXAMPLES[:3], 1))
    out = [None] * len(groups)

    def run(i):
        names, D = groups[i]
        out[i] = tw.spawn({name: dict(fn="example", name=name)
                           for name in names}, D,
                          tmp_path_factory.mktemp(f"ex{i}"))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(groups))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
        assert not t.is_alive()
    return {(name, D): [tw.result(out[i], name, r) for r in range(D)]
            for i, (names, D) in enumerate(groups) for name in names}


@pytest.mark.parametrize("name", PARALLEL_EXAMPLES)
def test_parallel_example_on_two_ranks(parallel_runs, name):
    """The example's asserts held on rank 0 of two gloo ranks (a failed
    assert fails its case); its DP run took both ranks, and every rank
    returned the same numbers (the DP solutions are replicated)."""
    r0, r1 = parallel_runs[name, 2]
    assert r0["D"] == 2
    assert r0 == r1


# What JAX's script prints, the port's ``main`` returns: each number's
# pattern in JAX's output and the distance allowed between the two. The
# scripts draw one problem (numpy, seed 0); JAX's runs in f64 on the
# tests' eight-device mesh, the port's in f32 on one or two ranks. A
# closed form or a count must agree to the printed digits; a solve to the
# printed digits and the gap f32 leaves there; a DP run, whose sampling
# streams differ with the package and the rank count, to 1e-3, 50 times
# inside the scripts' own bars (5e-2 for the Poisson fit, 0.05 |x_L1 -
# refit| ~ 1.4e-2 for MCP, 0.1 |x_LS - x_true| ~ 0.19 for Huber).
_F = r"([0-9.]+)"
JAX_LINES = {
    "robust_regression": [
        (("err_ls",), rf"least squares\s*: \|x - x_true\| = {_F}", (5e-5,)),
        (("err", "iters"), rf"huber\+katyusha\s*: \|x - x_true\| = {_F}"
         rf"\s+\({_F} outer", (1e-4, 0)),
        (("err_dp",), rf"dp katyusha x\d+ : \|x - x_true\| = {_F}", (1e-4,)),
    ],
    "poisson_glm": [
        (("nonzeros", "iters", "support", "corr"),
         rf"katyusha\s*: {_F} nonzeros \({_F} outer steps\), support hit "
         rf"{_F}/6, corr {_F}", (0, 0, 0, 1e-3)),
        (("err_dp",), rf"dp katyusha x\d+ : \|x - x_single\| = {_F}",
         (1e-3,)),
    ],
    "nonconvex_sparse_mcp": [
        (("err_l1",), rf"L1 \(lasso\)\s*: support=\d+, \|x - refit\| = {_F}",
         (1e-4,)),
        (("err_mcp", "iters"), rf"MCP \+ SARAH : support=\d+, \|x - refit\| "
         rf"= {_F}\s+\({_F} outer", (2e-5, 0)),
        (("err_dp",), rf"dp sarah x\d+ : \|x - refit\| = {_F}", (1e-3,)),
    ],
}


@pytest.fixture(scope="module")
def jax_prints():
    """Each of JAX's three parallel scripts run once, as
    ``tests/test_examples.py`` runs them; what each printed."""
    import contextlib
    import io

    out = {}
    for name in JAX_LINES:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _jax(name).main()
        out[name] = buf.getvalue()
    return out


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("name", list(JAX_LINES))
def test_parallel_example_matches_jax(parallel_runs, jax_prints, name, D):
    """Every number JAX's script prints against the one the port's
    ``main`` returns on D gloo ranks, within JAX_LINES' distance."""
    import re

    port = parallel_runs[name, D][0]
    assert port["D"] == D
    for keys, pattern, tols in JAX_LINES[name]:
        m = re.search(pattern, jax_prints[name])
        assert m, (pattern, jax_prints[name])
        for key, want, tol in zip(keys, m.groups(), tols):
            assert abs(port[key] - float(want)) <= tol, (key, port[key],
                                                         want)


def test_robust_regression_baseline_matches_jax(parallel_runs, jax_prints):
    """Both packages draw one problem: the closed-form least-squares
    baseline of the port's run prints as the JAX script's does, and
    Huber + Katyusha meets the script's bar in both."""
    line = next(s for s in jax_prints["robust_regression"].splitlines()
                if s.startswith("least squares"))
    port = parallel_runs["robust_regression", 2][0]
    assert line.split("=")[1].strip() == f"{port['err_ls']:.4f}"
    assert port["err"] < 0.1 * port["err_ls"]


@pytest.mark.parametrize("name", PARALLEL_EXAMPLES)
def test_parallel_examples_refuse_the_cpu_unasked(name, monkeypatch):
    """With no card and no device named, each parallel example's ``main``
    raises RuntimeError before it starts a process group."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _port(name).main()
    assert not dist.is_initialized()


@pytest.mark.parametrize("path", [f"examples_torch/{e}.py"
                                  for e in PARALLEL_EXAMPLES] + [
    "ciao_tpu_torch/parallel/placement.py",
    "ciao_tpu_torch/monitor/__init__.py"])
def test_parallel_examples_import_no_jax(path):
    """The parallel examples, the placement tables and the monitor name
    no ``jax`` and nothing of ``ciao_tpu`` in any import."""
    test_entry_points_import_no_jax(path)


# ---------------------------------------------------------------------------
# the names JAX's modules export
# ---------------------------------------------------------------------------

# helpers of the pytree registry, the TPU and threefry, which torch has not
LEFT_OUT = {"oracles": {"register_oracle", "static_field"},
            "prox": {"register_prox"}, "runtime": {"on_tpu"},
            "sampling": {"uniform_index"}}


def _public(mod) -> set:
    import types

    names = getattr(mod, "__all__", None)
    if names is None:
        names = [k for k in dir(mod) if not k.startswith("_")]
    return {k for k in names
            if not isinstance(getattr(mod, k), types.ModuleType)
            and getattr(getattr(mod, k), "__module__", None) not in (
                "typing", "pathlib", "__future__")}


def test_every_public_name_of_jax_has_its_counterpart():
    """Each module of ``ciao_tpu`` against the port's module of its name:
    the port lacks only the pytree, TPU and threefry helpers (listed as
    deliberate deviations)."""
    import importlib
    import pkgutil

    import ciao_tpu

    for sub in [""] + [m.name for m in pkgutil.iter_modules(
            ciao_tpu.__path__)]:
        jm = importlib.import_module("ciao_tpu" + (f".{sub}" if sub else ""))
        tm = importlib.import_module("ciao_tpu_torch"
                                     + (f".{sub}" if sub else ""))
        assert _public(jm) - _public(tm) == LEFT_OUT.get(sub, set()), sub


def test_ops_modes_and_both_gate_forms(monkeypatch):
    """``ciao_tpu_torch.ops`` exports JAX's five formula modes with JAX's
    values and its two shape gates in JAX's ``(N, n, B, dtype)`` form,
    ``dtype`` the iterate's as in JAX: open on a card for whole blocks,
    n <= MAX_COLS and f32 iterates, closed otherwise and with no card,
    and agreeing with the shape rules of the gates the solvers call. The
    solvers' gates keep the port's ``(F, g, x0, B)`` form (a deliberate
    deviation: they must see the oracle's mode, its rows' storage and
    the prox)."""
    import inspect

    import ciao_tpu.ops as jops
    from ciao_tpu_torch import ops, runtime
    from ciao_tpu_torch.ops import (
        MODE_HUBER, MODE_LOGISTIC, MODE_LSQ, MODE_POISSON, MODE_SQHINGE,
        coeff_multistep_available, fused_block_available,
    )
    from ciao_tpu_torch.ops import fused_block as fb

    assert (MODE_LSQ, MODE_LOGISTIC, MODE_HUBER, MODE_SQHINGE,
            MODE_POISSON) == (jops.MODE_LSQ, jops.MODE_LOGISTIC,
                              jops.MODE_HUBER, jops.MODE_SQHINGE,
                              jops.MODE_POISSON)
    for gate in (fused_block_available, coeff_multistep_available):
        assert list(inspect.signature(gate).parameters) == [
            "N", "n", "B", "dtype"]
        assert not gate(4096, 1024, 512, torch.float32)  # no card here
    monkeypatch.setattr(runtime, "on_cuda", lambda: True)
    shapes = [(262_144, 1_024, 4_096), (4096, 1024, 500), (4096, 16_384, 512),
              (4096, 16_385, 512), (4096, 1, 4096)]
    for gate in (fused_block_available, coeff_multistep_available):
        for N, n, B in shapes:
            assert gate(N, n, B, torch.float32) == fb._shape_ok(N, n, B)
            for dt in (torch.bfloat16, torch.float64, torch.int8):
                assert not gate(N, n, B, dt)               # f32 iterates
        assert gate(262_144, 1_024, 4_096, torch.float32)
        assert not gate(4096, 1024, 500, torch.float32)      # N % B
        assert not gate(4096, 16_385, 512, torch.float32)    # n > MAX_COLS
    for name in ("svrg_multistep_available", "finito_multistep_available",
                 "lfinito_sweep_available"):
        assert list(inspect.signature(getattr(ops, name)).parameters) == [
            "F", "g", "x0", "B"], name
        assert list(inspect.signature(getattr(jops, name)).parameters) == [
            "N", "n", "B", "dtype"], name


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    """``monitor.profiler_trace`` on the CPU: the file it writes when the
    block exits parses as a Chrome trace and holds the op run inside the
    block; the profile's averages name it too."""
    import json

    from ciao_tpu_torch.monitor import profiler_trace

    with profiler_trace(tmp_path / "trace") as prof:
        torch.cdist(torch.ones(8, 4), torch.zeros(8, 4))
    files = list((tmp_path / "trace").glob("*.json"))
    assert [str(f) for f in files] == [prof.trace_path]
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::cdist" for e in events)
    assert any(e.key == "aten::cdist" for e in prof.key_averages())
