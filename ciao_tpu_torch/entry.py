"""Driver entry point (counterpart of ``__graft_entry__.py``'s ``entry``).

``entry(device=None)`` — the flagship fused step: one launch window (8
steps) of streamed-table coefficient SAGA on a planted Lasso, which on
the card is one launch of ``saga_coeff_multistep_streamed`` (kernel #4).

    python -m ciao_tpu_torch.entry          # on the card
    python -m ciao_tpu_torch.entry cpu      # on the CPU (plain versions)

``dryrun_multichip`` waits for the port of ``ciao_tpu/parallel``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ciao_tpu_torch import runtime


def _lasso_setup(N, n, dtype, device):
    """``__graft_entry__.py``'s problem: ``make_lasso(N, n, p=max(2,
    n // 8), seed=0)`` as a ``LeastSquaresRows`` of ``dtype`` on
    ``device`` with scale N, ``NormL1(λ)``, L and a zero x0."""
    from ciao_tpu_torch.oracles import LeastSquaresRows
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.utils.problems import make_lasso

    prob = make_lasso(N=N, n=n, p=max(2, n // 8), seed=0, dtype=dtype)
    tdt = torch.from_numpy(np.zeros(0, dtype)).dtype
    F = LeastSquaresRows(torch.tensor(prob.A, dtype=tdt, device=device),
                         torch.tensor(prob.b, dtype=tdt, device=device),
                         float(N))
    g = NormL1(float(prob.lam)).to(device)
    L = torch.tensor(prob.L, dtype=tdt, device=device)
    x0 = torch.zeros(n, dtype=tdt, device=device)
    return prob, F, g, L, x0


def entry(device=None):
    """(fn, args): ``fn(F, g, state)`` runs 8 steps of streamed-table
    coefficient SAGA (``SAGACfg(..., fused_stream=True)``) at N = 8,192,
    n = 128, B = 128 (d = 64 blocks) in f32, γ = 1/(3·max L): one launch
    of kernel #4 on the card, its plain version on the CPU. Runs on the
    card unless ``device`` names another device; with no card and no
    device it raises ``RuntimeError``."""
    from ciao_tpu_torch.solvers.saga import SAGACfg, saga_init, saga_run

    dev = runtime.entry_device(device)
    N, n, batch = 8_192, 128, 128
    _, F, g, L, x0 = _lasso_setup(N, n, np.float32, dev)
    gamma = 1.0 / (3.0 * torch.max(L))
    cfg = SAGACfg(N=N, sag=False, batch=batch, block=True, coeff=True,
                  fused_stream=True)
    state = saga_init(F, g, x0, gamma, 0, cfg)

    def fn(F, g, state):
        return saga_run(F, g, state, cfg, 8)

    return fn, (F, g, state)


def main(argv) -> int:
    fn, args = entry("cpu" if "cpu" in argv else None)
    out = fn(*args)
    if out.z.is_cuda:
        torch.cuda.synchronize()
    print("entry: ok, it =", int(out.it))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
