"""Multi-process execution of the port's DP and TP paths.

Counterpart of ``tests/test_multihost.py``. JAX wires two processes into
one global mesh with ``jax.distributed``; the port's processes join one
process group from the environment ``torchrun`` sets
(``init_method="env://"``, ``CIAO_MULTIHOST``, as
``examples_torch/multihost.py`` does). Two such processes
(``tests/torch_multihost_worker.py``) run DPSAGA lockstep and in local
rounds, TPSAGA on a (1, 2) mesh and ``deep_solve_dp`` with every
collective across the process boundary over gloo, and are held to the
same runs on two ranks that ``torch.multiprocessing`` spawns
(``tests/torch_parallel_worker.py``) at JAX's bar, rtol 1e-12: the
schedules are functions of (seed, step, rank), so the way the processes
were started must not change the math.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import torch
import torch_parallel_worker as tw
from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_multihost_worker.py")
WORLD = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the two env-started processes' results, the spawned ranks')."""
    out = tmp_path_factory.mktemp("mh")
    port = _free_port()
    env = dict(os.environ, CIAO_MULTIHOST="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE=str(WORLD),
               LOCAL_WORLD_SIZE=str(WORLD), JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(HERE), HERE]
                   + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    # output to files, not pipes: two processes blocked in a collective
    # must not wait on a parent draining the other's full pipe
    logs = [open(out / f"rank{r}.log", "wb") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, WORKER, str(out)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (out / f"rank{r}.log").read_text()
    env_run = torch.load(out / "multihost.pt", weights_only=False)
    spawned = tw.spawn({"mh": dict(fn="multihost")}, WORLD,
                       tmp_path_factory.mktemp("mh_spawn"))
    return env_run, tw.result(spawned, "mh")


@pytest.mark.parametrize("key", ["lockstep", "local", "tp", "deep"])
def test_env_started_processes_match_spawned_ranks(runs, key):
    """DPSAGA lockstep and local rounds, TPSAGA on (1, 2) and
    ``deep_solve_dp`` across the process boundary equal the spawned
    ranks' runs at rtol 1e-12 (tests/test_multihost.py's bar)."""
    env_run, spawned = runs
    assert env_run["world"] == WORLD
    np.testing.assert_allclose(env_run[key], spawned[key], rtol=1e-12,
                               atol=1e-12)


def test_env_started_gap_recorded(runs):
    """The lockstep run made real progress: 0 < gap < half the gap at
    x0 (tests/test_multihost.py:144)."""
    env_run, _ = runs
    assert 0 < env_run["gap"] < 0.5 * env_run["x0_gap"]


def test_env_started_deep_solve_dp(runs):
    """``deep_solve_dp`` across the process boundary reaches rel <= 1e-6
    (tests/test_multihost.py:153)."""
    env_run, _ = runs
    assert env_run["rel_deep"] <= 1e-6, env_run["rel_deep"]


def test_multihost_template_refuses_env_without_rank(monkeypatch):
    """``examples_torch/multihost.py`` with ``CIAO_MULTIHOST`` set but no
    ``RANK`` raises before it starts a process group."""
    import importlib.util

    import torch.distributed as dist

    monkeypatch.setenv("CIAO_MULTIHOST", "1")
    monkeypatch.delenv("RANK", raising=False)
    spec = importlib.util.spec_from_file_location(
        "port_ex_multihost", os.path.join(os.path.dirname(HERE),
                                          "examples_torch", "multihost.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="RANK"):
        mod.main(device="cpu")
    assert not dist.is_initialized()
