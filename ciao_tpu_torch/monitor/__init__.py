"""Convergence monitoring.

Counterpart of ``ciao_tpu/monitor``: the objective, the sharing
objective, the fixed-point residual, the structured ``Trace`` and the
``observer`` callback of the facades' ``observe=`` hook. The reference
computes no convergence metric in its main path (stop ≡ false,
``Finito.jl:74``); these are what a run on the card reads instead.
``profiler_trace`` records a Chrome trace of a block through
``torch.profiler``, where JAX's records an xprof trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch


def fixed_point_residual(z_prev, z_next, gamma):
    """||z_next - z_prev|| / gamma — the stationarity surrogate of these
    fixed-point iterations."""
    return torch.sqrt(torch.sum(torch.abs(z_next - z_prev) ** 2)) / gamma


def objective(F, g, x):
    """(1/N) Σ f_i(x) + g(x), computed with the full-pass oracle."""
    vals, _ = F.value_and_grad_all(x)
    return torch.sum(vals) / F.num_terms + g.value(x)


def sharing_objective(F, g, xs):
    """(1/N) Σ f_i(x_i) + g(Σ x_i) — the sharing formulation's objective
    (``test_sharing.jl:1``) at the (N, n) block solution, each f_i at its
    own block point (``value_and_grad_pointwise``), g at the block sum."""
    N = F.num_terms
    vals, _ = F.value_and_grad_pointwise(xs, torch.arange(N,
                                                          device=xs.device))
    return torch.sum(vals) / N + g.value(torch.sum(xs, dim=0))


@dataclass
class Trace:
    """Structured per-checkpoint metric log (JSONL-dumpable)."""

    records: List[Dict[str, Any]] = field(default_factory=list)
    t0: float = field(default_factory=time.perf_counter)

    def log(self, it: int, **metrics):
        rec = {"it": int(it), "t": time.perf_counter() - self.t0}
        for k, v in metrics.items():
            rec[k] = float(v)
        self.records.append(rec)

    def dump(self, path):
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec) + "\n")

    def last(self, key, default=None):
        for rec in reversed(self.records):
            if key in rec:
                return rec[key]
        return default


def observer(F, g, trace: Trace, objective_every: bool = True, h=None,
             K=None):
    """An ``observe(it, state)`` callback for the facades' ``observe=``
    hook: logs the objective and the stepsize-scaled fixed-point
    residual ||z_k − z_{k-1}||/γ̂ into ``trace`` every ``freq``
    iterations. A state whose solution is (N, n) (ProShI's blocks) logs
    the sharing objective at the blocks, not the finite-sum objective at
    its coupling variable ``z``. ``h``/``K`` extend the objective for the
    three-term families (Davis-Yin: + h(x); Condat-Vũ and Chambolle-Pock:
    + h(Kx), K from ``ciao_tpu_torch.ops.linmap``). The residual follows
    ``state.z`` where the family carries one, else the solution, scaled
    by the state's ``hat_gamma``, ``gamma`` or (primal-dual) ``tau``."""
    prev = {}

    def observe(it, state):
        z = state.solution
        rec = {}
        if objective_every:
            if z.ndim == 2:
                rec["obj"] = float(sharing_objective(F, g, z))
            else:
                obj = objective(F, g, z)
                if h is not None:
                    obj = obj + h.value(z if K is None else K.matvec(z))
                rec["obj"] = float(obj)
        zres = getattr(state, "z", None)
        if zres is None:
            zres = z
        if "z" in prev:
            gam = None
            for name in ("hat_gamma", "gamma", "tau"):
                gam = getattr(state, name, None)
                if gam is not None:
                    break
            gam = torch.max(torch.as_tensor(1.0 if gam is None else gam))
            rec["residual"] = float(fixed_point_residual(prev["z"], zres, gam))
        prev["z"] = zres
        trace.log(it, **rec)

    return observe


@contextlib.contextmanager
def profiler_trace(logdir):
    """Context manager: record a trace of everything inside and write it
    to ``logdir`` as a Chrome trace (JSON, ``trace-<pid>-<ns>.json``) when
    the block exits, the counterpart of JAX's xprof ``profiler_trace``.
    It records CPU activity, and CUDA activity when a card is present;
    the block gets the ``torch.profiler.profile`` (``key_averages()``),
    whose ``trace_path`` names the file once the block has exited::

        with monitor.profiler_trace("/tmp/trace") as prof:
            state = run(state, 100)
            torch.cuda.synchronize()
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(os.fspath(logdir),
                        f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path
