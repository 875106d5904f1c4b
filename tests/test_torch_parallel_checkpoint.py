"""The port's sharded checkpoint and elastic restore on gloo ranks.

Counterparts of ``tests/test_parallel.py:1487`` (a DP-sharded SAGA state
saved per shard, restored with the same placement and resumed bit for
bit), ``:1726`` (restored onto a smaller mesh, 4 -> 2 ranks here) and
``:1821`` (onto a larger one, 2 -> 4). JAX's orbax writes each shard
and reshards into a template's layout; the port's ``save_async(...,
mesh=)`` writes each rank's parts into a directory, and ``load_orbax``
reads into the template's placement on the new mesh
(``ciao_tpu_torch.parallel.placement`` states it once per state class).

Every DP state class resumes bit for bit on its own mesh, as do TP
states on a (2, 2) mesh; one TP state moves onto (1, 2). A placement
table that forgets a cut field fails through the check of the fields
placed whole, on every rank. ``save`` without a mesh refuses a group of
more than one rank, and with one it writes the gathered global state.
The ranks run in processes spawned once for the module
(``tests/torch_parallel_worker.py``).
"""

import numpy as np
import pytest
import torch

import torch_parallel_worker as tw
from ciao_tpu_torch.utils.problems import make_lasso
from torch_threads import one_torch_thread  # noqa: F401

D = 4
N, n = 64, 8
ALL = [0, 1, 2, 3]
HALF = [0, 1]
SQUARE = dict(mesh2d=(2, 2), ranks=ALL)
PAIR = dict(mesh2d=(1, 2), ranks=HALF)
BOX, TV = 0.6, 0.05


def _prob():
    return make_lasso(N=N, n=n, p=3, seed=3)


def _base(prob):
    return dict(oracle={"kind": "lsq", "A": prob.A, "b": prob.b,
                        "scale": float(N)},
                prox={"kind": "l1", "lam": float(prob.lam)},
                L=prob.L, x0=np.zeros(n), N=N)


def _sharing_base():
    """tests/test_parallel.py's 24-block sharing problem (the reference's
    3 blocks, test_sharing.jl:13-24, replicated 8x)."""
    d = np.tile(np.array([[1.0, 2.0], [-1.0, 3.0], [0.0, 10.0]]), (8, 1))
    Nb = d.shape[0]
    eta = Nb * 10.0
    return dict(oracle={"kind": "sharing", "d": d, "q": np.ones_like(d),
                        "lo": -2.0, "hi": 2.0, "eta": eta, "n_terms": Nb},
                prox={"kind": "box", "lo": -np.inf, "hi": np.ones(2)},
                L=np.abs(d).max(axis=1) + eta, x0=np.zeros(2), N=Nb)


# every DP state class: name -> (facade, knobs, case overrides)
DP_CASES = {
    "saga": ("DPSAGA", dict(batch=8, seed=11), {}),
    "saga_local": ("DPSAGA", dict(batch=8, block_sampling=True,
                                  local_steps=4, seed=2), {}),
    "finito": ("DPFinito", dict(batch=16, sweeping=2, table="full"), {}),
    "finito_coeff": ("DPFinito", dict(batch=16, sweeping=3, table="coeff",
                                      seed=3), {}),
    "finito_adaptive": ("DPFinito", dict(adaptive=True, sweeping=2), {}),
    "lfinito": ("DPFinito", dict(LFinito=True, batch=16, sweeping=3), {}),
    "svrg": ("DPSVRG", dict(batch=8, m=N, local_inner=True, seed=4), {}),
    "proshi": ("DPProshi", dict(batch=8, local_steps=3, sweeping=2),
               "sharing"),
    "fista": ("DPFISTA", {}, {}),
    "katyusha": ("DPKatyusha", dict(batch=8, seed=5), {}),
    "sarah": ("DPSARAH", dict(batch=8, m=N, seed=6), {}),
    "lsvrg": ("DPLSVRG", dict(batch=8, seed=7), {}),
    "lkatyusha": ("DPLKatyusha", dict(batch=8, seed=8), {}),
    "point_saga": ("DPPointSAGA", dict(batch=8, seed=9),
                   dict(prox={"kind": "zero"})),
    "ssnm": ("DPSSNM", dict(batch=8, seed=10), {}),
    "davis_yin": ("DPDavisYin", {}, {"h": {"kind": "box", "lo": -BOX,
                                          "hi": BOX}}),
    "condat_vu": ("DPCondatVu", {}, {"h": {"kind": "l1", "lam": TV},
                                     "K": "first_difference"}),
    "panoc": ("DPPANOC", {}, {}),
}
TP_CASES = {"TPSAGA": dict(batch=8, seed=1),
            "TPFinito": dict(batch=8, sweeping=3, seed=2),
            "TPPANOC": {}}
STEPS, OVERLAP, MORE = 5, 3, 10


def _cases(prob, tmp):
    base = dict(_base(prob), fn="ckpt", dir=str(tmp), steps=STEPS,
                overlap=OVERLAP, more=MORE)
    cases = {}
    for name, (cls, kw, extra) in DP_CASES.items():
        if extra == "sharing":
            extra = _sharing_base()
        cases["dp_" + name] = dict(base, cls=cls, kw=kw, path="dp_" + name,
                                   **extra)
    for cls, kw in TP_CASES.items():
        cases["tp_" + cls] = dict(base, cls=cls, kw=kw, path="tp_" + cls,
                                  save_on=SQUARE)
    cases["tp_shrink"] = dict(base, cls="TPSAGA", kw=TP_CASES["TPSAGA"],
                              path="tp_shrink", save_on=SQUARE,
                              load_on=PAIR)
    saga = dict(base, cls="DPSAGA", kw=dict(batch=8, seed=11),
                more=0, overlap=0)
    cases["shrink"] = dict(saga, path="shrink", steps=200, load_on=HALF,
                           after=3000)
    cases["grow"] = dict(saga, path="grow", steps=100, save_on=HALF,
                         load_on=None, after=3000)
    cases["gathered"] = dict(base, cls="DPSAGA", path="gathered.pt",
                             kw=dict(batch=8, block_sampling=True, seed=12),
                             gather=True, load_on=HALF, overlap=0)
    cases["tp_gathered"] = dict(base, cls="TPSAGA", kw=TP_CASES["TPSAGA"],
                                path="tp_gathered.pt", save_on=SQUARE,
                                load_on=PAIR, gather=True, overlap=0)
    cases["errors"] = dict(base, fn="ckpt_errors", cls="DPSAGA",
                           kw=dict(batch=8), path="errors", three=[0, 1, 2],
                           three_rows=N // 3)
    return cases


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    prob = _prob()
    tmp = tmp_path_factory.mktemp("ckpt")
    results = tw.spawn(_cases(prob, tmp / "files"), D, tmp)
    return prob, tmp / "files", results


def _ranks(results, name, ranks=ALL):
    return [tw.result(results, name, r) for r in ranks]


def _equal(a: dict, b: dict, where: str) -> None:
    """Every field of ``a`` bit for bit ``b``'s (tensors and scalars)."""
    assert a.keys() == b.keys(), where
    for k, v in a.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == b[k].dtype and v.shape == b[k].shape, (where, k)
            assert np.array_equal(v, b[k], equal_nan=True), (where, k)
        else:
            assert v == b[k], (where, k)


def _global(parts, name, key):
    """A DP field's global rows, the ranks' parts in mesh order."""
    parts = sorted(parts, key=lambda p: p[key]["d"])
    return np.concatenate([p[name.split(":")[0]][name.split(":")[1]]
                           for p in parts])


@pytest.mark.parametrize("name", list(DP_CASES))
def test_dp_state_resumes_bit_for_bit_on_its_mesh(setup, name):
    """Each DP state class: saved with ``save_async(..., mesh=)`` after
    five steps while the solver steps on, restored with ``load_orbax``
    into the facade's init state on the same four ranks: every field of
    each rank bit for bit the saved one (its parts of the cut fields, the
    whole fields, seed, it and status), and ten steps resumed from it
    bit for bit the straight run's."""
    _, _, results = setup
    for r, out in enumerate(_ranks(results, "dp_" + name)):
        _equal(out["restored"], out["saved"], f"rank {r} restored")
        _equal(out["resumed"], out["straight"], f"rank {r} resumed")
        assert out["like_it"] == 1 and out["restored"]["it"] > 1


def test_sharded_resume_keeps_the_rows_cut(setup):
    """tests/test_parallel.py:1487: the restored full SAGA table is the
    rank's (16, 8) rows, not the gathered (64, 8) table, and the restore
    happened beside a solver that stepped on during the write."""
    _, path, results = setup
    outs = _ranks(results, "dp_saga")
    for r, out in enumerate(outs):
        assert out["restored"]["s"].shape == (N // D, n)
        assert out["save_at"] == dict(d=r, m=0, D=D, M=1)
    assert sorted(p.name for p in (path / "dp_saga").iterdir()) == [
        "manifest.pt"] + [f"shard-{r}-0.pt" for r in range(D)]


def test_no_mesh_reads_a_sharded_checkpoint_whole(setup):
    """One process with no group restores the four ranks' directory into
    a template of global shapes: the table is the ranks' rows in order,
    the whole fields and scalars rank 0's."""
    from ciao_tpu_torch.checkpoint import load_orbax
    from ciao_tpu_torch.parallel.dp import DPSAGAState

    _, path, results = setup
    outs = _ranks(results, "dp_saga")
    saved = outs[0]["saved"]
    like = DPSAGAState(s=torch.zeros(N, n, dtype=torch.float64),
                       gamma=torch.zeros((), dtype=torch.float64),
                       av=torch.zeros(n, dtype=torch.float64),
                       z=torch.zeros(n, dtype=torch.float64), seed=0, it=1,
                       status=0)
    back = load_orbax(path / "dp_saga", like)
    assert np.array_equal(back.s.numpy(),
                          np.concatenate([o["saved"]["s"] for o in outs]))
    for f in ("gamma", "av", "z"):
        assert np.array_equal(getattr(back, f).numpy(), saved[f]), f
    assert (back.seed, back.it, back.status) == (
        saved["seed"], saved["it"], saved["status"])


@pytest.mark.parametrize("case,save_on,load_on", [
    ("shrink", ALL, HALF), ("grow", HALF, ALL)])
def test_elastic_restore_onto_another_mesh(setup, case, save_on, load_on):
    """tests/test_parallel.py:1726 and :1821: a DPSAGA state saved on one
    mesh (200 steps on 4 ranks, or 100 on 2) is restored onto another
    (2 ranks, or 4): its global table comes back bit for bit, cut to the
    new mesh's rows, and 3,000 steps on the new mesh reach the planted
    optimum within JAX's 1e-4 gap. The trajectory after the move differs
    from a run on the old mesh (the schedules hash the rank)."""
    prob, _, results = setup
    saved = _ranks(results, case, save_on)
    restored = _ranks(results, case, load_on)
    for key in ("s", "av", "z", "gamma"):
        if key == "s":
            a = _global(saved, "saved:s", "save_at")
            b = _global(restored, "restored:s", "load_at")
        else:
            a, b = saved[0]["saved"][key], restored[0]["restored"][key]
        assert np.array_equal(a, b), key
    for out in restored:
        assert out["restored"]["s"].shape == (N // len(load_on), n)
        assert out["restored"]["it"] == saved[0]["saved"]["it"]
    gap = prob.cost(restored[0]["final"]) - prob.f_star
    assert gap < 1e-4, gap


def test_gathered_file_restores_onto_two_ranks(setup):
    """``save(..., mesh=)`` on four ranks writes one file of the global
    state; ``load_orbax`` restores it onto two ranks (each its 32
    coefficient rows) and the resume runs on."""
    _, _, results = setup
    saved = _ranks(results, "gathered")
    restored = _ranks(results, "gathered", HALF)
    assert np.array_equal(_global(saved, "saved:s", "save_at"),
                          _global(restored, "restored:s", "load_at"))
    assert restored[0]["restored"]["s"].shape == (N // 2,)
    assert np.array_equal(restored[0]["restored"]["z"],
                          saved[0]["saved"]["z"])
    assert restored[0]["resumed"]["it"] == saved[0]["saved"]["it"] + MORE


@pytest.mark.parametrize("cls", list(TP_CASES))
def test_tp_state_resumes_bit_for_bit_on_its_mesh(setup, cls):
    """TPSAGA, TPFinito and TPPANOC states on a (2, 2) mesh: each rank's
    shards (rows, columns, both) and whole fields restored bit for bit,
    and the resume bit for bit the straight run."""
    _, _, results = setup
    for r, out in enumerate(_ranks(results, "tp_" + cls)):
        _equal(out["restored"], out["saved"], f"rank {r} restored")
        _equal(out["resumed"], out["straight"], f"rank {r} resumed")


@pytest.mark.parametrize("case", ["tp_shrink", "tp_gathered"])
def test_tp_state_restores_onto_a_smaller_mesh(setup, case):
    """A TPSAGA state of the (2, 2) mesh, saved per shard or gathered by
    ``save(..., mesh=)`` into one file, restored onto (1, 2): each rank's
    coefficient rows are all N, its iterate and average its half of the
    columns, the same bits as the (2, 2) ranks held."""
    _, _, results = setup
    saved = _ranks(results, case)
    restored = _ranks(results, case, HALF)
    s = np.concatenate([saved[0]["saved"]["s"], saved[2]["saved"]["s"]])
    for m, out in enumerate(restored):
        assert out["load_at"] == dict(d=0, m=m, D=1, M=2)
        assert np.array_equal(out["restored"]["s"], s)
        for f in ("z", "av"):
            assert np.array_equal(out["restored"][f], saved[m]["saved"][f])


def test_forgotten_field_fails_on_every_rank(setup):
    """With DPSAGAState's cut ``s`` left out of the placement table,
    ``save_async(..., mesh=)`` raises ValueError naming it on every rank
    (the ranks' rows differ, so the check of the fields placed whole
    catches it); no rank writes it from its own rows."""
    _, _, results = setup
    for out in _ranks(results, "errors"):
        assert out["forgotten"] is not None and "['s']" in out["forgotten"]


def test_refusals(setup):
    """``save`` and ``save_async`` without a mesh refuse the four-rank
    group and name ``mesh=``; a restore onto three ranks, over which the
    64 rows do not divide, and into a template of another class raise
    ValueError."""
    _, _, results = setup
    for r in ALL:
        out = tw.result(results, "errors", r)
        assert "mesh=" in out["save"] and "load_orbax" in out["save"]
        assert "mesh=" in out["save_async"]
        if r < 3:
            assert "do not divide" in out["divide"]
            assert "DPFBState" in out["class"]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The fault's setting: two gloo ranks, a DPSAGA state of N = 256."""
    prob = make_lasso(N=256, n=16, p=4, seed=1)
    tmp = tmp_path_factory.mktemp("ckpt2")
    base = dict(oracle={"kind": "lsq", "A": prob.A, "b": prob.b,
                        "scale": 256.0},
                prox={"kind": "l1", "lam": float(prob.lam)}, L=prob.L,
                x0=np.zeros(16), N=256, dir=str(tmp / "files"),
                cls="DPSAGA", kw=dict(batch=8, seed=1))
    cases = {"gather": dict(base, fn="ckpt", path="whole.pt", gather=True,
                            steps=20, more=0),
             "errors": dict(base, fn="ckpt_errors", path="errors",
                            three=None)}
    return tmp / "files", tw.spawn(cases, 2, tmp)


def test_save_gathers_or_refuses_on_two_ranks(two_ranks):
    """``save`` of a two-rank DPSAGA state: without a mesh it raises
    ValueError on both ranks (it wrote the rank's (128, 16) rows to one
    shared path, and the ranks raced on its temporary file); with the
    mesh the file holds the global (256, 16) table, bit for bit the two
    ranks' rows, and loads in one process."""
    from ciao_tpu_torch import checkpoint

    path, results = two_ranks
    for r in (0, 1):
        assert "mesh=" in tw.result(results, "errors", r)["save"]
    parts = [tw.result(results, "gather", r)["saved"] for r in (0, 1)]
    whole = checkpoint.load(path / "whole.pt", device="cpu")
    assert whole.s.shape == (256, 16)
    assert np.array_equal(whole.s.numpy(),
                          np.concatenate([p["s"] for p in parts]))
    assert np.array_equal(whole.z.numpy(), parts[0]["z"])
