"""Shared solver machinery.

Counterpart of ``ciao_tpu/solvers/base.py``: each solver family is an
(immutable config, state, init, step) quadruple driven by a take/halt
loop (reference ``Finito.jl:118-128``). Steps are plain functions on
tensors; PyTorch runs them eagerly, so a chunk of steps is a Python loop.

  * init    -> ``init(F, g, ...)``; counts as iteration #1 exactly like
               the reference (``maxit=1`` == init only).
  * steps   -> ``run_chunk(state, k)``; a ``status`` field replaces the
               reference's return-``nothing`` early abort.
  * stream  -> :class:`SolverIterable`, an infinite iterable of states.
"""

from __future__ import annotations

import enum
import itertools
import warnings
from typing import Any, Callable

import torch

from ciao_tpu_torch import runtime


class Status(enum.IntEnum):
    RUNNING = 0
    GAMMA_UNDERFLOW = 1  # adaptive backtracking abort (Finito_adaptive.jl:123-125)
    CONVERGED = 2        # tolerance met (PANOC/ZeroFPR ‖x−z‖/γ ≤ tol)


def solution(state):
    """View of the current solution — the only exported symbol of the
    reference (``Finito.jl:25``)."""
    return state.solution


def facade_device(device, x0) -> torch.device:
    """The device a facade runs on: the one the caller names, else x0's
    when it is a tensor, else :func:`runtime.default_device` (the card
    when there is one)."""
    if device is not None:
        return torch.device(device)
    if isinstance(x0, torch.Tensor):
        return x0.device
    return runtime.default_device()


def default_terms(F, g, N, device):
    """A facade's ``(F, g, N)`` on ``device``: N from F when not given,
    the reference's defaults F = ``ZeroOracle(n_terms=N)`` (Finito.jl:78)
    and g = ``Zero()`` (Finito.jl:69) for None."""
    from ciao_tpu_torch.oracles import ZeroOracle
    from ciao_tpu_torch.prox import Zero

    if N is None:
        if F is None:
            raise ValueError("provide F or N")
        N = F.num_terms
    if F is None:
        F = ZeroOracle(n_terms=N)
    return F.to(device), (Zero() if g is None else g).to(device), N


def real_dtype_of(x) -> torch.dtype:
    """The real dtype of a tensor or dtype (float32 for complex64)."""
    dtype = x if isinstance(x, torch.dtype) else torch.as_tensor(x).dtype
    return dtype.to_real()


def rdiv(a: float, t):
    """``a / t`` for a Python number ``a``, as one rounded divide in
    ``t``'s dtype, as JAX divides by a weakly typed scalar (torch's
    ``a / t`` multiplies by the reciprocal: two roundings)."""
    return torch.full_like(t, a) / t


def resolve_gamma_array(gamma, L, N, alpha, rdt, device=None,
                        who="Finito"):
    """Per-index stepsizes γ_i as an (N,) tensor of ``rdt`` on ``device``.

    Mirrors ``Finito_basic.jl:61-74``: an explicit γ (scalar or (N,))
    wins; otherwise γ_i = α·N / L_i from the Lipschitz moduli (a scalar L
    is broadcast). Missing both is the reference's ``@warn``-and-stop
    path."""
    if gamma is not None:
        g = torch.as_tensor(gamma, dtype=rdt, device=device)
        return g.expand(N).clone() if g.ndim == 0 else g
    if L is None:
        raise ValueError(f"{who}: smoothness parameter absent — provide L or γ")
    return rdiv(alpha * N, torch.as_tensor(L, dtype=rdt,
                                           device=device).expand(N))


class SolverIterable:
    """Infinite state stream matching the reference's bare-iterable
    contract: ``iter.x0`` aliases the user's x0 (``test_lasso.jl:151``),
    the first state is the init state, iteration halts only on solver
    abort. Steps are queued on the device with no host sync unless the
    solver can abort (``can_abort``), which reads ``status`` per step."""

    def __init__(self, x0, init_fn: Callable[[], Any],
                 step_fn: Callable[[Any], Any],
                 rebase_fn: Callable[[Any], Any] | None = None,
                 can_abort: bool = False):
        self.x0 = x0
        self._init_fn = init_fn
        self._step_fn = step_fn
        # optional state-repair hook for resuming a state produced under
        # a different oracle row storage (see saga.saga_rebase)
        self._rebase_fn = rebase_fn
        self._can_abort = can_abort

    def __iter__(self):
        yield from self.resume(self._init_fn())

    def resume(self, state):
        """The stream from ``state``: yields it, then keeps stepping
        (``checkpoint.resume_iterator`` continues a restored state
        here)."""
        yield state
        while True:
            state = self._step_fn(state)
            if self._can_abort and int(state.status) != Status.RUNNING:
                # a CONVERGED state is the best iterate — yield it; an
                # aborted one (γ underflow) is invalid — drop it
                if int(state.status) == Status.CONVERGED:
                    yield state
                return
            yield state


def take(iterable, k):
    """itertools.islice, named to match the reference's Base.Iterators.take."""
    return itertools.islice(iterable, k)


def loop(iterable):
    """Consume an iterable, returning its last element (the reference's
    ``IterationTools.loop``)."""
    last = None
    for last in iterable:
        pass
    return last


def halt(iterable, stop):
    """Yield states until ``stop(state)`` is true, yielding the stopping
    state last (the reference's ``IterationTools.halt``)."""
    for state in iterable:
        yield state
        if stop(state):
            return


def run_solver_loop(
    init_fn,
    run_chunk,
    maxit: int,
    verbose: bool,
    freq: int,
    disp: Callable[[int, Any], None],
    observe: Callable[[int, Any], None] = None,
):
    """Reference run loop (``Finito.jl:118-133``): init counts as
    iteration 1, then maxit-1 steps; progress printed every ``freq``.

    ``run_chunk(state, num_steps)`` advances up to ``num_steps`` steps.
    ``observe(it, state)``, when given, is called on the init state and
    then every ``freq`` iterations (and on the final state).
    Returns ``(final_state, num_iters)`` where num_iters counts yielded
    states (init + completed steps).
    """
    state = init_fn()
    it = 1
    if observe is not None:
        observe(it, state)
    remaining = maxit - 1
    chunk = freq if (verbose or observe is not None) else max(remaining, 1)
    while remaining > 0:
        n = min(chunk, remaining)
        state = run_chunk(state, n)
        remaining -= n
        done = int(state.it)  # states carry their own yield count
        if verbose and done % freq == 0:
            disp(done, state)
        if observe is not None:
            observe(done, state)
        it = done
        if int(state.status) != Status.RUNNING:
            break
    if verbose and it % freq != 0:
        disp(it, state)
    if int(state.status) == Status.GAMMA_UNDERFLOW:
        warnings.warn("parameter γ became too small — solver aborted early")
    return state, it
