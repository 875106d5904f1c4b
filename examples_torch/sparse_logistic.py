"""rcv1-style sparse L1-logistic on one card: the hybrid hot/cold layout.

The port of ``examples/sparse_logistic.py``. Doc x term matrices are
power-law: a few columns carry most of the nonzeros.
``HybridSparseLogistic`` stores those columns dense (an (N, D) block, one
matrix product) and only the tail in ELL (gathers and scatter-adds). The
logistic coefficients c_i = −y_i σ(−y_i ⟨a_i, x⟩) keep every gradient
rank 1, so the coefficient-table SAGA and the accelerated Katyusha run
unchanged on the sparse operator. No kernel lies on this route (the JAX
package runs it outside Pallas too).

    python examples_torch/sparse_logistic.py            # on the card
    python examples_torch/sparse_logistic.py small      # smoke shapes
    python examples_torch/sparse_logistic.py small cpu

Problem: synthetic power-law features (D_hot dense columns at ~60 %
density + a K-sparse tail), labels from a planted hyperplane with 10 %
flips; objective (1/N) Σ log(1+exp(−y_i⟨a_i,x⟩)) + λ‖x‖₁, λ = 1/N. The
draws are the JAX example's (numpy, seed 0), so both packages get one
problem.
"""

import sys
import time

import numpy as np
import torch

from ciao_tpu_torch import runtime
from ciao_tpu_torch.oracles import HybridSparseLogistic
from ciao_tpu_torch.prox import NormL1
from ciao_tpu_torch.solvers.katyusha import (
    KatyushaCfg, katyusha_init, katyusha_run,
)
from ciao_tpu_torch.solvers.saga import SAGACfg, saga_init, saga_run


def build(N, n, d_hot, k_tail, seed=0, device=None):
    """(F, L, y): the ELL/hybrid fields straight from numpy (no dense
    (N, n) ever materialized, the point of the layout), on ``device``."""
    rng = np.random.default_rng(seed)
    hot = rng.choice(n, size=d_hot, replace=False).astype(np.int32)
    d_pad = max(128, -(-d_hot // 128) * 128)
    hot_cols = np.zeros(d_pad, np.int32)
    hot_cols[:d_hot] = hot
    A_hot = rng.standard_normal((N, d_pad)).astype(np.float32)
    A_hot[:, d_hot:] = 0.0
    A_hot *= (rng.random((N, d_pad)) < 0.6)  # ~60 % dense-block density
    cold = np.setdiff1d(np.arange(n, dtype=np.int32), hot)
    idx = rng.choice(cold, size=(N, k_tail)).astype(np.int32)
    val = rng.standard_normal((N, k_tail)).astype(np.float32)

    # labels from a planted hyperplane (10 % label noise)
    w = rng.standard_normal(n).astype(np.float32)
    margin = A_hot[:, :d_hot] @ w[hot] + (val * w[idx]).sum(axis=1)
    y = np.sign(margin).astype(np.float32)
    y[y == 0] = 1.0
    flip = rng.random(N) < 0.1
    y[flip] = -y[flip]

    def t(a):
        return torch.from_numpy(a).to(device)

    F = HybridSparseLogistic(t(A_hot), t(hot_cols), t(idx), t(val), t(y),
                             n_dim=n)
    L = 0.25 * ((A_hot ** 2).sum(axis=1) + (val ** 2).sum(axis=1))
    return F, t(L), y


def objective(F, x, N):
    """(1/N) Σ log(1 + exp(−y_i m_i)) + ‖x‖₁/N, from the layout's fields."""
    m = (F.A_hot.to(x.dtype) @ x[F.hot_cols.long()]
         + torch.sum(F.val * x[F.idx.long()], dim=1))
    return float(torch.mean(torch.logaddexp(torch.zeros_like(m), -F.y * m))
                 + torch.sum(torch.abs(x)) / N)


def main(N=1_048_576, n=65_536, d_hot=256, k_tail=8, B=4_096, small=False,
         device=None):
    dev = runtime.entry_device(device)
    if small:
        N, n, d_hot, k_tail, B = 4_096, 1_024, 16, 4, 256
    F, L, y = build(N, n, d_hot, k_tail, device=dev)
    g = NormL1(1.0 / N)
    x0 = torch.zeros(n, device=dev)

    print(f"N={N:,} n={n:,} hot={d_hot} K={k_tail} "
          f"({(F.A_hot.numel() + 2 * F.idx.numel()) * 4 / 2**30:.2f} GiB "
          f"layout vs {N * n * 4 / 2**30:.1f} GiB dense)")
    obj0 = objective(F, x0, N)
    print(f"objective(0) = {obj0:.6f}")

    # SAGA, coefficient table + contiguous blocks
    cfg = SAGACfg(N=N, sag=False, batch=B, block=True, coeff=True)
    gam = torch.tensor(1.0 / (3.0 * float(torch.max(L))), device=dev)
    st = saga_init(F, g, x0, gam, 0, cfg)
    spe = N // B
    epochs = 2 if small else 20
    _ = float(saga_run(F, g, st, cfg, spe).z[0])  # warm
    t0 = time.perf_counter()
    st = saga_run(F, g, st, cfg, epochs * spe)
    _ = float(st.z[0])
    dt = time.perf_counter() - t0
    obj_saga = objective(F, st.z, N)
    print(f"SAGA: {epochs} epochs in {dt:.2f}s "
          f"({epochs * N / dt / 1e6:.1f} M samples/s), "
          f"objective {obj_saga:.6f}")

    # Katyusha on the same operator (acceleration pays in epochs)
    m = 2 * N // B
    kcfg = KatyushaCfg(N=N, batch=B, m=m, block=True, ns=True)
    stk = katyusha_init(F, g, x0, torch.max(L), 0.5, 0.5, 0, kcfg)
    outers = 1 if small else 7  # ≈ 3 epochs each
    _ = float(katyusha_run(F, g, stk, kcfg, 1).x_tilde[0])  # warm
    t1 = time.perf_counter()
    stk = katyusha_run(F, g, stk, kcfg, outers)
    _ = float(stk.x_tilde[0])
    dtk = time.perf_counter() - t1
    obj_kat = objective(F, stk.x_tilde, N)
    print(f"Katyusha: {outers} outer steps ({3 * outers} epoch-equivalents) "
          f"in {dtk:.2f}s, objective {obj_kat:.6f}")
    return dict(objective0=obj0, saga=obj_saga, katyusha=obj_kat,
                saga_s=dt, saga_steps=epochs * spe, katyusha_s=dtk,
                katyusha_outer=outers)


if __name__ == "__main__":
    main(small="small" in sys.argv[1:],
         device="cpu" if "cpu" in sys.argv[1:] else None)
