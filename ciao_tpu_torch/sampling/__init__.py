"""Block schedules: the sweeps of the Finito family, the importance and
clamped-launch helpers.

Counterpart of ``ciao_tpu/sampling/__init__.py``. Sweeping strategies
(reference ``Finito.jl:153``):
  1 = uniformly random (without replacement within a minibatch)
  2 = cyclic over static contiguous blocks
  3 = shuffled block order, re-shuffled every epoch

Behavioral parity notes (SURVEY.md §2.1), kept bit for bit:
  * blocks are STATIC contiguous ranges of size ``batch`` with a ragged
    final block (Finito_basic.jl:50-58); ``mask`` flags the valid lanes;
  * in shuffled mode the FIRST epoch runs in natural order and the order
    is re-shuffled when ``pos == d`` (Finito_basic.jl:100-107);
  * cyclic sweeps carry the reference's 1-based ``idxr``.

torch cannot draw threefry, so the draws are the port's own, each a pure
function of (seed, position) through the counter hash :func:`_mix32`:
the e'th shuffled permutation is the argsort of the hash over (seed, e,
block), computed where ``order`` lies (the same permutation on the CPU
and on the card, with no host sync); iid block ids hash (seed, draw
count); a RANDOM minibatch (B distinct rows) comes from a generator
seeded by (seed, draw count). A :class:`SweepState` therefore carries
its seed and the count of permutations drawn in place of a key.
Positions are Python ints, block orders tensors.

Also here: :func:`clip_block_distribution` (host float64 numpy, a copy
of the JAX package's, which this package cannot import) and
:func:`first_duplicate` on tensors.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch


class Sweep(enum.IntEnum):
    RANDOM = 1
    CYCLIC = 2
    SHUFFLED = 3


# ---------------------------------------------------------------------------
# the counter hash of every draw of the port
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mulmod32(x, c: int):
    """(x·c) mod 2^32 for uint32 values held in int64 tensors (or Python
    ints), multiplied in 16-bit halves so no product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """The ``lowbias32`` integer finalizer: a bijection of uint32 with
    good avalanche, the round function of the counter-based draws."""
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mulmod32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _seed_key(seed: int) -> int:
    return _mix32(_mix32(seed & _M32) ^ ((seed >> 32) & _M32))


def _permutation(seed: int, epoch: int, d: int, device):
    """The ``epoch``'th shuffled order of the d blocks: the argsort of
    the hash of (seed, epoch, block). The hash is a bijection of the
    block id for a fixed (seed, epoch), so there are no ties. (d,) int32
    on ``device``."""
    salt = _mix32(_seed_key(seed) ^ _mix32((epoch & _M32) ^ 0x3C6EF372))
    h = _mix32(torch.arange(d, dtype=torch.int64, device=device) ^ salt)
    return torch.argsort(h).to(torch.int32)


def _uniform_blocks(seed: int, pos0: int, k: int, d: int, device):
    """The iid uniform block ids of draws pos0..pos0+k-1: (k,) int32."""
    s = torch.arange(pos0, pos0 + k, dtype=torch.int64, device=device)
    h = _mix32(_mix32((s & _M32) ^ _seed_key(seed)) ^ 0x165667B1)
    return ((h * d) >> 32).to(torch.int32)


# ---------------------------------------------------------------------------
# sweep states
# ---------------------------------------------------------------------------

class SweepState(NamedTuple):
    """Index-schedule carry: the 1-based position within the current
    epoch (the draw count of a RANDOM sweep), the (d,) block order of
    the current epoch, the seed of the draws, and the count of shuffled
    permutations drawn so far."""

    pos: int
    order: torch.Tensor
    seed: int = 0
    epoch: int = 0


def num_blocks(n: int, batch: int) -> int:
    return -(-n // batch)  # ceil


def init_sweep(seed: int, n: int, batch: int, sweeping: int = Sweep.RANDOM,
               device="cpu") -> SweepState:
    d = num_blocks(n, batch)
    # cyclic carries the reference's 1-based ``idxr`` (init 1 → first
    # step lands on block 2, Finito_basic.jl:99 with init :44); shuffled
    # carries ``idx`` (init 0 → first epoch in natural order)
    pos0 = 1 if sweeping == Sweep.CYCLIC else 0
    return SweepState(pos=pos0, order=torch.arange(d, dtype=torch.int32,
                                                   device=device),
                      seed=int(seed), epoch=0)


def reshuffled(state: SweepState, d: int) -> SweepState:
    """``state`` with the next permutation drawn as its order (LFinito
    draws one at the start of every epoch, Finito_LFinito.jl:86-89)."""
    epoch = state.epoch + 1
    return state._replace(order=_permutation(state.seed, epoch, d,
                                             state.order.device),
                          epoch=epoch)


def next_block_id(state: SweepState, n: int, batch: int, sweeping: int):
    """Advance a schedule one step, returning the 0-based BLOCK id (a
    Python int for cyclic sweeps, a 0-d device tensor otherwise) and the
    new state."""
    d = num_blocks(n, batch)
    if sweeping == Sweep.RANDOM:
        # stateless iid uniform block id in (seed, pos); ``pos`` is a
        # plain draw counter here (no epoch wrap)
        j = _uniform_blocks(state.seed, state.pos, 1, d,
                            state.order.device)[0]
        return j, state._replace(pos=state.pos + 1)
    if sweeping == Sweep.CYCLIC:
        new_pos = state.pos % d + 1  # reference: idxr = mod(idxr, d) + 1
        return new_pos - 1, state._replace(pos=new_pos)
    if sweeping == Sweep.SHUFFLED:
        # reference: when pos == d, draw a fresh permutation and restart
        # at position 1; otherwise advance (Finito_basic.jl:100-107)
        if state.pos == d:
            state = reshuffled(state, d)._replace(pos=1)
        else:
            state = state._replace(pos=state.pos + 1)
        return state.order[state.pos - 1], state
    raise ValueError(f"block schedules need sweeping 2 or 3; got {sweeping}")


def _random_rows(seed: int, pos: int, n: int, batch: int, device):
    """The ``batch`` distinct rows of RANDOM draw ``pos``, from a
    generator seeded by (seed, pos): (batch,) int64."""
    gen = torch.Generator(device=device)
    gen.manual_seed((_seed_key(seed) << 32) | _mix32((pos & _M32) ^ 0x85EBCA6B))
    if batch == 1:
        return torch.randint(n, (1,), generator=gen, device=device)
    return torch.randperm(n, generator=gen, device=device)[:batch]


def next_block(state: SweepState, n: int, batch: int, sweeping: int):
    """Advance the schedule one step. Returns ``(idx, mask, new_state)``
    with ``idx`` a (batch,) int64 index tensor and ``mask`` the
    valid-lane booleans (a ragged final block's lanes past ``n`` are
    clamped to n − 1 and masked)."""
    dev = state.order.device
    if sweeping == Sweep.RANDOM:
        idx = _random_rows(state.seed, state.pos, n, batch, dev)
        return (idx, torch.ones(batch, dtype=torch.bool, device=dev),
                state._replace(pos=state.pos + 1))
    block, new_state = next_block_id(state, n, batch, sweeping)
    idx = block * batch + torch.arange(batch, device=dev)
    mask = idx < n
    return idx.clamp(max=n - 1), mask, new_state


def _shuffled_window(state: SweepState, k: int, d: int):
    """The k shuffled block ids at positions pos..pos+k-1 and the orders
    of the epochs they reach: epoch e of the window uses the state's
    order (e = 0) or the next permutations. Returns (blocks, orders)."""
    dev = state.order.device
    s = torch.arange(state.pos, state.pos + k, dtype=torch.int64,
                     device=dev)
    E = (state.pos + k - 1) // d + 1
    orders = torch.stack([state.order] + [
        _permutation(state.seed, state.epoch + e, d, dev)
        for e in range(1, E)])
    return orders[s // d, s % d], orders


def _advanced(state: SweepState, c: int, d: int, orders) -> SweepState:
    """The shuffled state after ``c`` committed draws of a window."""
    r = (state.pos + c - 1) // d  # epoch boundaries crossed
    return SweepState(pos=(state.pos + c - 1) % d + 1, order=orders[r],
                      seed=state.seed, epoch=state.epoch + r)


def gen_block_ids(state: SweepState, k: int, n: int, batch: int,
                  sweeping: int):
    """The next ``k`` block ids of a schedule in ONE vectorized draw,
    (k,) int32 on the order's device, plus the advanced state —
    identical to ``k`` calls of :func:`next_block_id`."""
    d = num_blocks(n, batch)
    dev = state.order.device
    if sweeping == Sweep.RANDOM:
        return (_uniform_blocks(state.seed, state.pos, k, d, dev),
                state._replace(pos=state.pos + k))
    if sweeping == Sweep.CYCLIC:
        s = torch.arange(state.pos, state.pos + k, dtype=torch.int64,
                         device=dev)
        return ((s % d).to(torch.int32),
                state._replace(pos=(state.pos + k - 1) % d + 1))
    if sweeping != Sweep.SHUFFLED:
        raise ValueError(f"block schedules need sweeping 2 or 3; got "
                         f"{sweeping}")
    blocks, orders = _shuffled_window(state, k, d)
    return blocks, _advanced(state, k, d, orders)


def gen_block_ids_clamped(state: SweepState, k: int, n: int, batch: int,
                          sweeping: int):
    """The next ``k`` CANDIDATE block ids, the clamp count ``f`` (the
    largest prefix of distinct blocks, a 0-d int32 tensor) and the state
    advanced by ``f`` draws only: the discarded candidates are drawn
    again by the next call, so consuming f steps per launch reproduces
    the stepwise stream. The count is read on the host once, to advance
    the state. The port's drivers do not clamp (its kernels keep their
    tables in device memory); this serves the tests that replay JAX's
    clamped loop and the clamped drivers still to port."""
    d = num_blocks(n, batch)
    if sweeping == Sweep.RANDOM:
        blocks = _uniform_blocks(state.seed, state.pos, k, d,
                                 state.order.device)
        f = first_duplicate(blocks)
        return blocks, f, state._replace(pos=state.pos + int(f))
    if sweeping != Sweep.SHUFFLED:
        raise ValueError(f"gen_block_ids_clamped serves sweeping 1 or 3; "
                         f"got {sweeping}")
    blocks, orders = _shuffled_window(state, k, d)
    f = first_duplicate(blocks)
    return blocks, f, _advanced(state, int(f), d, orders)


# ---------------------------------------------------------------------------
# importance and clamp helpers
# ---------------------------------------------------------------------------

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
    count of a launch that must not revisit a block. The port's SAGA and
    Finito drivers do not clamp; this serves :func:`gen_block_ids_clamped`,
    the clamped JAX drivers still to port (Point-SAGA, SSNM) and the
    tests that replay JAX's clamped loop."""
    K = blocks.shape[0]
    eq = blocks[:, None] == blocks[None, :]                  # eq[j, i]
    earlier = torch.ones((K, K), dtype=torch.bool,
                         device=blocks.device).tril(-1)      # i < j
    dup = (eq & earlier).any(dim=1)
    first = torch.argmax(dup.to(torch.int32))
    return torch.where(dup.any(), first, K).to(torch.int32)
