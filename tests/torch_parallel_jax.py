"""The JAX side of the port's data-parallel parity tests.

Each rank's schedule is read from the JAX package's own draws: its
``local_block_start``, ``local_indices`` and ``_local_round_starts`` run
under ``shard_map`` on the first D devices of the 8-device CPU mesh, so
every draw folds in the device's ``axis_index`` as it does in a solve.
The port's ranks take these as explicit schedules
(``tests/torch_parallel_worker.py``); JAX's run draws them itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ciao_tpu.oracles import LeastSquaresRows
from ciao_tpu.parallel import DATA_AXIS, make_mesh, shard_finite_sum
from ciao_tpu.parallel import dp as jdp
from ciao_tpu.prox import NormL1

# the f64 parity bound, relative to each field's largest entry
TOL = 1e-10


def mesh(D: int):
    return make_mesh(n_data=D)


def per_device(m, fn):
    """``fn()`` on each device of the mesh's data axis under
    ``shard_map``, stacked (D, ...) as numpy."""
    f = jax.shard_map(lambda: fn()[None], mesh=m, in_specs=(),
                      out_specs=P(DATA_AXIS), check_vma=False)
    return np.asarray(jax.jit(f)())


def block_starts(m, seed, steps, n_loc, B, sweeping, it0=1):
    """(D, steps): each device's ``local_block_start`` of steps it0.."""
    key = jax.random.PRNGKey(seed)
    its = jnp.arange(it0, it0 + steps, dtype=jnp.int32)
    return per_device(m, lambda: jax.vmap(
        lambda it: jdp.local_block_start(key, it, n_loc, B, sweeping))(its))


def indices(m, seed, steps, n_loc, B, sweeping):
    """(D, steps, B): each device's ``local_indices`` of steps 1.."""
    key = jax.random.PRNGKey(seed)
    its = jnp.arange(1, steps + 1, dtype=jnp.int32)
    return per_device(m, lambda: jax.vmap(
        lambda it: jdp.local_indices(key, it, n_loc, B, sweeping))(its))


def rounds(m, seed, n_rounds, K, n_loc, B, sweeping):
    """(D, n_rounds, K): each device's ``_local_round_starts`` of the
    rounds starting at it = 1, 1 + K, ..."""
    key = jax.random.PRNGKey(seed)
    return np.stack([per_device(m, lambda t=t: jdp._local_round_starts(
        key, 1 + t * K, n_loc, B, K, sweeping)) for t in range(n_rounds)],
        axis=1)


def lfinito_orders(m, seed, steps, d_loc, B, sweeping):
    """(D, steps, d_loc): each device's LFinito epoch order of epochs
    it = 1.., as block starts."""
    key = jax.random.PRNGKey(seed)
    if sweeping != 3:
        one = np.arange(d_loc, dtype=np.int32) * B
        return np.broadcast_to(one, (m.shape[DATA_AXIS], steps, d_loc)).copy()

    def orders():
        ax = jax.lax.axis_index(DATA_AXIS)
        return jnp.stack([jax.random.permutation(
            jax.random.fold_in(jax.random.fold_in(key, it), ax), d_loc)
            for it in range(1, steps + 1)]) * B

    return per_device(m, orders).astype(np.int32)


def svrg_starts(m, seed, steps, m_inner, n_loc, B):
    """(D, steps, m): the inner block starts of outer steps 1.. (the
    lockstep and local modes share them)."""
    key = jax.random.PRNGKey(seed)
    return np.stack([per_device(m, lambda it=it: jdp._local_round_starts(
        jax.random.fold_in(key, it), 1, n_loc, B, m_inner, 1))
        for it in range(1, steps + 1)], axis=1)


def svrg_plus_starts(m, seed, steps, m0, n_loc, B):
    """Per device, the list of SVRG++ outer steps' inner block starts,
    m doubling from m0."""
    key = jax.random.PRNGKey(seed)
    per = [per_device(m, lambda it=it: jdp._local_round_starts(
        jax.random.fold_in(key, it), 1, n_loc, B, m0 * 2 ** (it - 1), 1))
        for it in range(1, steps + 1)]
    return [[p[r] for p in per] for r in range(m.shape[DATA_AXIS])]


def svrg_rows(m, seed, steps, m_inner, n_loc, B):
    """(D, steps, m, B): the inner iid rows of outer steps 1..: JAX's
    ``randint(fold_in(fold_in(fold_in(key, it), k), axis_index))``."""
    key = jax.random.PRNGKey(seed)

    def rows(it):
        ks = jax.random.fold_in(key, it)
        ax = jax.lax.axis_index(DATA_AXIS)
        return jax.vmap(lambda k: jax.random.randint(
            jax.random.fold_in(jax.random.fold_in(ks, k), ax), (B,), 0,
            n_loc, dtype=jnp.int32))(jnp.arange(m_inner))

    return np.stack([per_device(m, lambda it=it: rows(it))
                     for it in range(1, steps + 1)], axis=1)


def step_rows(m, seed, steps, n_loc, B):
    """(D, steps, B): the loopless families' iid rows of steps 1..:
    JAX's ``randint(fold_in(fold_in(key, it), axis_index))``."""
    key = jax.random.PRNGKey(seed)

    def rows():
        ax = jax.lax.axis_index(DATA_AXIS)
        return jax.vmap(lambda it: jax.random.randint(
            jax.random.fold_in(jax.random.fold_in(key, it), ax), (B,), 0,
            n_loc, dtype=jnp.int32))(jnp.arange(1, steps + 1))

    return per_device(m, rows)


def coins(seed, steps, p, D):
    """(D, steps): the loopless families' anchor coins of steps 1..,
    JAX's ``solvers.lsvrg._coin`` at an f32 p, the same on every
    device."""
    from ciao_tpu.solvers.lsvrg import _coin

    key = jax.random.PRNGKey(seed)
    pf = jnp.asarray(p, jnp.float32)
    c = np.array([bool(_coin(key, jnp.int32(it), pf))
                  for it in range(1, steps + 1)])
    return np.broadcast_to(c, (D, steps)).copy()


def adaptive_indices(seed, steps, N, sweeping, D):
    """(D, steps): the adaptive variant's global index of steps 1..,
    the same on every device, from the key chain its steps carry."""
    key = jax.random.PRNGKey(seed)
    idx = []
    for it in range(1, steps + 1):
        idx.append(int(jdp._global_single_index(key, jnp.int32(it), N,
                                                sweeping)))
        key = jax.random.split(key)[0]  # each step splits the state's key
    idx = np.array(idx)
    return np.broadcast_to(idx, (D, steps)).copy()


def lsq(A, b, scale, m, dtype=jnp.float64, storage=None):
    F = LeastSquaresRows(A=jnp.asarray(A, dtype), b=jnp.asarray(b, dtype),
                         scale=jnp.asarray(float(scale), dtype))
    if storage:
        F = F.with_storage(storage)
    return shard_finite_sum(F, m)


def l1(lam, dtype=jnp.float64):
    return NormL1(lam=jnp.asarray(lam, dtype))


def run(m, family, F, g, cfg, x0, gamma, seed, steps, extra=()):
    """JAX's ``build_dp_functions`` from init through ``steps`` steps."""
    init_c, _, run_c, _ = jdp.build_dp_functions(
        family, m, F, g, cfg, extra_init_scalars=len(extra))
    st = init_c(F, g, x0, gamma, *extra, jax.random.PRNGKey(seed))
    return run_c(F, g, st, steps)


def gap(a, b) -> float:
    """max |a − b| relative to b's largest entry (at least 1e-300)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b), initial=0.0)
                 / max(np.max(np.abs(b), initial=0.0), 1e-300))


def compare(ranks, jst, local=(), tol=TOL):
    """Each rank's fields against JAX's state: ``local`` fields against
    the rank's rows of JAX's sharded array, every other array field
    against JAX's whole one, and ``it``. Returns the largest gap."""
    D = len(ranks)
    worst = 0.0
    for r, st in enumerate(ranks):
        assert int(st["it"]) == int(jst.it)
        for f, v in st.items():
            jv = getattr(jst, f, None)
            if not isinstance(v, np.ndarray) or jv is None or f in (
                    "key", "seed"):
                continue
            jv = np.asarray(jv)
            if f in local:
                k = jv.shape[0] // D
                jv = jv[r * k:(r + 1) * k]
            e = gap(v, jv)
            assert e <= tol, (f, r, e)
            worst = max(worst, e)
    return worst


# ---------------------------------------------------------------------------
# the tensor-parallel path: JAX runs on make_mesh_2d(D, M) of the first D·M
# devices; every draw folds only the data row, so each row's draws are read
# on the first D devices of a 1-D mesh
# ---------------------------------------------------------------------------

def mesh2d(D: int, M: int):
    from ciao_tpu.parallel import make_mesh_2d

    return make_mesh_2d(D, M, devices=jax.devices()[:D * M])


def tp_saga_starts(m, seed, steps, n_loc, B):
    """(D, steps): TPSAGA's block starts (``tp.py:136-141``): the state's
    key split every step, the data row folded into the subkey."""
    key = jax.random.PRNGKey(seed)
    subs = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        subs.append(sub)
    subs = jnp.stack(subs)

    def draw():
        ax = jax.lax.axis_index(DATA_AXIS)
        return jax.vmap(lambda s: jax.random.randint(
            jax.random.fold_in(s, ax), (), 0, n_loc // B,
            dtype=jnp.int32) * B)(subs)

    return per_device(m, draw)


def tp_svrg_starts(m, seed, steps, m_inner, n_loc, B, plus=False):
    """Per data row, the list of TPSVRG outer steps' inner block starts
    (``tp.py:686-696``): randint(fold_in(fold_in(fold_in(key, it), row),
    k)); m doubles each outer step under ``plus``."""
    key = jax.random.PRNGKey(seed)
    per = []
    for it in range(1, steps + 1):
        k_in = m_inner * 2 ** (it - 1) if plus else m_inner

        def draw(it=it, k_in=k_in):
            ax = jax.lax.axis_index(DATA_AXIS)
            ks = jax.random.fold_in(jax.random.fold_in(key, it), ax)
            return jax.vmap(lambda k: jax.random.randint(
                jax.random.fold_in(ks, k), (), 0, n_loc // B,
                dtype=jnp.int32) * B)(jnp.arange(k_in))

        per.append(per_device(m, draw))
    return [[p[r] for p in per] for r in range(m.shape[DATA_AXIS])]


def tp_run(solver, x0, F, g, L, steps, N=None):
    """A JAX TP facade's state after ``steps`` steps from init."""
    _, _, _, init, _, run, _ = solver._setup(x0, F, g, L, N)
    return run(init(), steps)


# each TP state field's cut: the axes of its dimensions (None: whole)
TP_AXES = {"z": ("model",), "av": ("model",), "z_full": ("model",),
           "w": ("model",), "x": ("model",), "y": ("model",),
           "s": ("data",), "c": ("data",), "invg": ("data",),
           "gamma": ("data",), "zb": ("data", "model"),
           "x_tilde": ("model",), "w_anchor": ("model",),
           "gbar": ("model",), "xg": ("model",), "gradx": ("model",),
           "pbase": ("model",), "presid": ("model",),
           "S": (None, "model"), "Y": (None, "model")}


def compare2d(ranks, jst, axes=None, tol=TOL):
    """Each rank's fields against JAX's global state: a cut field against
    the rank's part of JAX's array (``TP_AXES``, or ``axes`` for the
    family), a whole one against all of it; and ``it``. Returns the
    largest gap."""
    axes = dict(TP_AXES, **(axes or {}))
    worst = 0.0
    for st in ranks:
        assert int(st["it"]) == int(jst.it)
        for f, v in st.items():
            jv = getattr(jst, f, None)
            if not isinstance(v, np.ndarray) or jv is None:
                continue
            jv = np.asarray(jv)
            for dim, ax in enumerate(axes.get(f, ()) if v.ndim else ()):
                if ax is None:
                    continue
                parts, at = (st["D"], st["d"]) if ax == "data" else (
                    st["M"], st["m"])
                k = jv.shape[dim] // parts
                jv = np.take(jv, np.arange(at * k, (at + 1) * k), axis=dim)
            e = gap(v, jv)
            assert e <= tol, (f, st["d"], st["m"], e)
            worst = max(worst, e)
    return worst
