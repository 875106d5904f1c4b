"""Block-schedule helpers of the importance and clamped-launch paths.

Counterpart of ``ciao_tpu/sampling/__init__.py``, cut to what the deep
path needs: :func:`clip_block_distribution` (host float64 numpy, a copy
of the JAX package's, which this package cannot import) and
:func:`first_duplicate` on tensors. The sweep schedules
(``gen_block_ids``, ``gen_block_ids_clamped``) wait for the Finito and
ProShI slices (ROADMAP.md, queue 1 item 5).
"""

from __future__ import annotations

import numpy as np
import torch


def clip_block_distribution(q, K: int):
    """Water-fill-clip a block distribution so that no block carries more
    than 1/K of the mass: the largest c with q̃ ∝ min(q, c) and
    max q̃ = c/Σmin(q, c) ≤ 1/K (at the solution Σmin(q, c) = K·c, so
    every clipped block sits at exactly 1/K).

    With every inclusion probability π_j = K·q̃_j ≤ 1, the systematic
    draws of one K-step window (slot k takes grid point U + k against
    the π-scale CDF) are distinct by construction. Host float64: an f32
    cumsum over many blocks skews the realized draws. Returns
    ``(q_tilde, clipped)``, ``q_tilde`` summing to 1 and ``clipped`` the
    number of blocks at the cap (0 when no clipping was needed)."""
    q = np.asarray(q, np.float64)
    d = q.size
    K = min(K, d)
    Z0 = q.sum()
    if q.max() * K <= Z0:
        return q / Z0, 0
    qs = np.sort(q)[::-1]
    css = np.cumsum(qs)
    total = css[-1]
    for m in range(1, K):
        c = (total - css[m - 1]) / (K - m)
        lo = qs[m] if m < d else 0.0
        if lo <= c < qs[m - 1]:
            qt = np.minimum(q, c)
            return qt / qt.sum(), int(np.sum(q > c))
    # mass concentrated on fewer than K blocks: only the uniform
    # distribution keeps every block at or under 1/K (reachable when K == d)
    return np.full(d, 1.0 / d), d


def first_duplicate(blocks):
    """Smallest j with ``blocks[j]`` in ``blocks[:j]``, else len(blocks),
    as a 0-d int32 tensor on the blocks' device (no host sync): the clamp
    count of a launch that must not revisit a block. The port's SAGA
    driver does not clamp; this serves the clamped drivers still to port
    (ProShI, Point-SAGA, SSNM) and the tests that replay JAX's clamped
    loop."""
    K = blocks.shape[0]
    eq = blocks[:, None] == blocks[None, :]                  # eq[j, i]
    earlier = torch.ones((K, K), dtype=torch.bool,
                         device=blocks.device).tril(-1)      # i < j
    dup = (eq & earlier).any(dim=1)
    first = torch.argmax(dup.to(torch.int32))
    return torch.where(dup.any(), first, K).to(torch.int32)
