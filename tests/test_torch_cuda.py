"""The CUDA kernels ``saga_coeff_multistep``,
``saga_coeff_multistep_streamed``, ``svrg_coeff_multistep``,
``coeff_apply_all``, ``finito_coeff_multistep``,
``finito_coeff_multistep_streamed``, ``lfinito_sweep_multistep``,
``finito_block_update``, ``saga_block_update``, ``proshi_multistep``,
``katyusha_coeff_multistep``, ``sarah_multistep``,
``lsvrg_coeff_multistep``, ``lkatyusha_coeff_multistep``,
``ssnm_multistep``, ``ssnm_multistep_streamed``, ``point_saga_multistep``,
``point_saga_multistep_streamed`` and ``coeff_value_apply_all`` against
their plain versions, ``coeff_apply_all`` and the kernels of the
persistent engine bit for bit against their pinned digests,
``coeff_value_apply_all``'s c and gsum bit for bit ``coeff_apply_all``'s,
the kernels of the persistent engine (#3, #4, #5, #8, #9, #10, #11, #12,
#13, #14, #15, #16, #17, #18, #19) at its edges, #3, #8, #9, #12, #13, #14,
#15, #16, #18 and #19 on two streams at once and #10, #11 and #16 in turns
on one, SSNM's and Point-SAGA's on hand-made block revisits, the facades'
routing to them, and the polish's exact-f32 check; and the sparse rows,
which no kernel serves: their protocols on the card against the CPU, and
the SAGA facade on them launching no kernel; and the primal-dual deep
route, which no kernel serves either: ``deep_solve_pd`` on the card by
default and certified there, and its refinements repeating bit for bit;
and complex rows and iterates, which no kernel serves by design: each
complex facade on the card against the CPU, a complex iterate closing
every gate with no fallback warning, and ``CustomOracle`` and
``Precompose`` on the card.

These tests need an NVIDIA GPU (marker ``cuda``) and skip without one:
the kernel has no CPU mode. They import no JAX, so they run on a
machine with the card and PyTorch alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernel and the plain version run the same f32 arithmetic and sum in
other orders, so the states are held relative to their largest entry:
z within 1e-6 (exact-f32 dots) or 1e-5 (bf16-rounded dots), c and av
within 10x that.
"""

import pytest
import torch

from ciao_tpu_torch.ops import fused_block as tfb
from ciao_tpu_torch.oracles import LeastSquaresRows

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _setup(dev, N, n, B, K, storage, sag, weighted, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    A = torch.randn(N, n, generator=gen, device=dev)
    F = LeastSquaresRows(A, torch.randn(N, generator=gen, device=dev),
                         float(N))
    if storage != "f32":
        F = F.with_storage(storage)
    gamma = 1.0 / (3.0 * float((A * A).sum(1).max()) * N)
    z = 0.05 * torch.randn(n, generator=gen, device=dev)
    c = F.coeff_all(z)
    av = F.apply_all(c) / N
    starts = (torch.randint(N // B, (K,), generator=gen, device=dev) * B).to(
        torch.int32)
    sc = torch.tensor([N, gamma, gamma * 0.1, 1.0 / B, 1.0 / N,
                       1.0 if sag else 0.0, 0.0, 0.0], device=dev)
    wgts = (torch.rand(K, generator=gen, device=dev) + 0.5
            if weighted else None)
    return F, (c, z, av), starts, sc, wgts


def _run_both(F, state, starts, sc, B, precision, wgts):
    rows, offs = F.coeff_rows_data()
    outs = []
    for fn in (tfb.saga_coeff_multistep, tfb.saga_coeff_multistep_ref):
        st = [t.clone() for t in state]
        fn(rows, offs, starts, *st, sc, B, precision=precision,
           rs=F.coeff_rows_scale(), wgts=wgts)
        outs.append(st)
    torch.cuda.synchronize()
    return outs


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("weighted", [False, True], ids=["uniform", "wgts"])
@pytest.mark.parametrize("sag", [False, True], ids=["saga", "sag"])
@pytest.mark.parametrize("storage,precision,n", [
    ("f32", "highest", 256), ("f32", "default", 256), ("bf16", "highest", 256),
    ("int8", "highest", 256),
    # rows that are not whole 16-byte chunks take the one-value-at-a-time path
    ("f32", "highest", 202), ("bf16", "highest", 200), ("int8", "highest", 200),
], ids=["f32", "f32-default", "bf16", "int8", "f32-n202", "bf16-n200",
        "int8-n200"])
def test_kernel_matches_plain_version(dev, storage, precision, n, sag,
                                      weighted):
    N, B, K = 4096, 256, 32
    F, state, starts, sc, wgts = _setup(dev, N, n, B, K, storage, sag,
                                        weighted)
    before = tfb.saga_coeff_multistep.launches
    (kc, kz, kav), (rc, rz, rav) = _run_both(F, state, starts, sc, B,
                                             precision, wgts)
    assert tfb.saga_coeff_multistep.launches == before + 1
    lowp = tfb._lowp(F.A, precision)
    tol = 1e-5 if lowp else 1e-6
    assert float((rz - state[1]).abs().max()) > 0  # the steps moved z
    assert _rel(kz, rz) <= tol
    assert _rel(kav, rav) <= 10 * tol
    assert _rel(kc, rc) <= 10 * tol


def test_kernel_repeats_bit_for_bit(dev):
    """No atomics: two runs from one state give the same bits."""
    F, state, starts, sc, _ = _setup(dev, 4096, 256, 256, 16, "int8", False,
                                     False, seed=1)
    rows, offs = F.coeff_rows_data()
    runs = []
    for _ in range(2):
        st = [t.clone() for t in state]
        tfb.saga_coeff_multistep(rows, offs, starts, *st, sc, 256,
                                 rs=F.coeff_rows_scale())
        runs.append(st)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_wrapper_checks_its_arguments(dev):
    F, (c, z, av), starts, sc, _ = _setup(dev, 1024, 64, 128, 4, "f32",
                                          False, False)
    rows, offs = F.coeff_rows_data()
    with pytest.raises(TypeError, match="starts"):
        tfb.saga_coeff_multistep(rows, offs, starts.long(), c, z, av, sc, 128)
    with pytest.raises(ValueError, match="shape"):
        tfb.saga_coeff_multistep(rows, offs, starts, c[:512], z, av, sc, 128)
    with pytest.raises(ValueError, match="rs"):
        tfb.saga_coeff_multistep(rows, offs, starts, c, z, av, sc, 128,
                                 rs=torch.ones(1024, device=dev))
    with pytest.raises(ValueError, match="on cpu"):
        tfb.saga_coeff_multistep(rows, offs, starts, c, z.cpu(), av, sc, 128)
    with pytest.raises(ValueError, match="bad shape"):
        tfb.saga_coeff_multistep(rows, offs, starts, c, z, av, sc, 100)


# ---------------------------------------------------------------------------
# kernel #4: saga_coeff_multistep_streamed
# ---------------------------------------------------------------------------

def _run_streamed(F, state, starts, sc, B, precision, wgts, f):
    rows, offs = F.coeff_rows_data()
    outs = []
    for fn in (tfb.saga_coeff_multistep_streamed,
               tfb.saga_coeff_multistep_streamed_ref):
        st = [t.clone() for t in state]
        fn(rows, offs, starts, *st, sc, B, precision=precision,
           rs=F.coeff_rows_scale(), wgts=wgts, f=f)
        outs.append(st)
    torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize("f", [64, 23], ids=["f=K", "f=23"])
@pytest.mark.parametrize("weighted", [False, True], ids=["uniform", "wgts"])
@pytest.mark.parametrize("sag", [False, True], ids=["saga", "sag"])
@pytest.mark.parametrize("storage,precision", [
    ("f32", "highest"), ("f32", "default"), ("bf16", "highest"),
    ("int8", "highest"),
], ids=["f32", "f32-default", "bf16", "int8"])
def test_streamed_kernel_matches_plain_version(dev, storage, precision, sag,
                                               weighted, f):
    """K = 64 steps at N = 8,192, n = 128, B = 128 (d = 64, repeats
    included), clamp count f on the device; tolerances as above."""
    N, n, B, K = 8192, 128, 128, 64
    F, state, starts, sc, wgts = _setup(dev, N, n, B, K, storage, sag,
                                        weighted, seed=2)
    fc = torch.tensor([f], dtype=torch.int32, device=dev)
    before = tfb.saga_coeff_multistep_streamed.launches
    (kc, kz, kav), (rc, rz, rav) = _run_streamed(F, state, starts, sc, B,
                                                 precision, wgts, fc)
    assert tfb.saga_coeff_multistep_streamed.launches == before + 1
    tol = 1e-5 if tfb._lowp(F.A, precision) else 1e-6
    assert float((rz - state[1]).abs().max()) > 0
    assert _rel(kz, rz) <= tol
    assert _rel(kav, rav) <= 10 * tol
    assert _rel(kc, rc) <= 10 * tol


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_streamed_masked_steps_are_identity(dev, storage):
    """A launch clamped at f = 23 leaves c, z and av bit for bit as the
    first 23 steps alone leave them; f = None equals f = K."""
    F, state, starts, sc, wgts = _setup(dev, 8192, 128, 128, 64, storage,
                                        False, True, seed=3)
    rows, offs = F.coeff_rows_data()
    rs = F.coeff_rows_scale()

    def run(st, wg, f):
        out = [t.clone() for t in state]
        tfb.saga_coeff_multistep_streamed(rows, offs, st, *out, sc, 128,
                                          rs=rs, wgts=wg, f=f)
        torch.cuda.synchronize()
        return out

    f23 = torch.tensor([23], dtype=torch.int32, device=dev)
    for a, b in zip(run(starts, wgts, f23), run(starts[:23], wgts[:23], None)):
        assert torch.equal(a, b)
    f64 = torch.tensor(64, dtype=torch.int32, device=dev)
    for a, b in zip(run(starts, wgts, f64), run(starts, wgts, None)):
        assert torch.equal(a, b)
    f0 = torch.tensor([0], dtype=torch.int32, device=dev)
    for a, b in zip(run(starts, wgts, f0), state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_streamed_kernel_at_the_deep_target_shape(dev, storage):
    """K = 8 steps at the deep target's shape, N = 10,485,760 rows of
    n = 128, B = 8,192: 64-bit row offsets past 2^31 bytes."""
    N, n, B, K = 10 * 1024 * 1024, 128, 8192, 8
    F, state, starts, sc, _ = _setup(dev, N, n, B, K, storage, False, False,
                                     seed=4)
    starts[-1] = N - B  # the last block: its rows start 5.4 GB into f32 A
    (kc, kz, kav), (rc, rz, rav) = _run_streamed(F, state, starts, sc, B,
                                                 "highest", None, None)
    tol = 1e-5 if storage != "f32" else 1e-6
    assert _rel(kz, rz) <= tol
    assert _rel(kav, rav) <= 10 * tol
    assert _rel(kc, rc) <= 10 * tol


def test_streamed_wrapper_checks_f(dev):
    F, (c, z, av), starts, sc, _ = _setup(dev, 1024, 64, 128, 4, "f32",
                                          False, False)
    rows, offs = F.coeff_rows_data()
    with pytest.raises(TypeError, match="f must be"):
        tfb.saga_coeff_multistep_streamed(
            rows, offs, starts, c, z, av, sc, 128,
            f=torch.tensor([2], device=dev))
    with pytest.raises(ValueError, match="one count"):
        tfb.saga_coeff_multistep_streamed(
            rows, offs, starts, c, z, av, sc, 128,
            f=torch.tensor([2, 3], dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="on cpu"):
        tfb.saga_coeff_multistep_streamed(
            rows, offs, starts, c, z, av, sc, 128,
            f=torch.tensor([2], dtype=torch.int32))


def test_polish_and_plain_versions_raise_under_tf32(dev):
    """On the card the compensated gradient, the power bound and the
    plain kernel versions need exact f32 products: with TF32 on they
    raise, and they leave the flag as they found it."""
    from ciao_tpu_torch.solvers.polish import grad_mean_chunked, power_lmax

    F, (c, z, av), starts, sc, _ = _setup(dev, 1024, 64, 128, 4, "f32",
                                          False, False)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            grad_mean_chunked(F, z, 256)
        with pytest.raises(RuntimeError, match="TF32"):
            power_lmax(F, z, 0)
        rows, offs = F.coeff_rows_data()
        with pytest.raises(RuntimeError, match="TF32"):
            tfb.saga_coeff_multistep_ref(rows, offs, starts, c, z, av, sc,
                                         128)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    g = grad_mean_chunked(F, z, 256)
    want = F.apply_all(F.coeff_all(z)) / 1024
    assert _rel(g, want) <= 1e-5


def test_facade_sends_every_block_run_to_a_kernel(dev):
    """On the card a block-sampling run whose gate is open takes a kernel
    whatever its block count: N = 4,224 rows of B = 128 (d = 33, which
    the JAX package runs stepwise) go to the resident kernel with no
    fallback warning, 256 steps in two launches, and the objective
    falls."""
    import warnings

    from ciao_tpu_torch import SAGA
    from ciao_tpu_torch.monitor import objective
    from ciao_tpu_torch.prox import NormL1

    N, n, B = 4224, 64, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    A = torch.randn(N, n, generator=gen, device=dev)
    F = LeastSquaresRows(A, torch.randn(N, generator=gen, device=dev),
                         float(N))
    g = NormL1(torch.tensor(0.01, device=dev))
    x0 = torch.zeros(n, device=dev)
    before = tfb.saga_coeff_multistep.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        x, it = SAGA(maxit=257, block_sampling=True, batch=B)(
            x0, F=F, g=g, L=(A * A).sum(1) * N)
    assert it == 257
    assert tfb.saga_coeff_multistep.launches == before + 2
    assert float(objective(F, g, x)) < float(objective(F, g, x0))


# ---------------------------------------------------------------------------
# kernel #5: svrg_coeff_multistep
# ---------------------------------------------------------------------------

def _svrg_setup(dev, N, n, B, K, storage, lam, seed=0):
    """An SVRG-like state: anchor coefficients at a random z̃, av their
    mean gradient, w near z̃, zs a running sum; scalars [scale, γ, γλ,
    1/B, mode, aux]."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    A = torch.randn(N, n, generator=gen, device=dev)
    F = LeastSquaresRows(A, torch.randn(N, generator=gen, device=dev),
                         float(N))
    if storage != "f32":
        F = F.with_storage(storage)
    gamma = 1.0 / (10.0 * float((A * A).sum(1).max()) * N)
    zt = 0.05 * torch.randn(n, generator=gen, device=dev)
    canch = F.coeff_all(zt)
    av = F.apply_all(canch) / N
    w = zt + 0.01 * torch.randn(n, generator=gen, device=dev)
    zs = 0.1 * torch.randn(n, generator=gen, device=dev)
    starts = (torch.randint(N // B, (K,), generator=gen, device=dev) * B).to(
        torch.int32)
    sc = torch.tensor([N, gamma, gamma * lam, 1.0 / B, 0.0, 0.0],
                      device=dev)
    return F, canch, (w, zs), av, starts, sc


def _run_svrg(F, canch, state, av, starts, sc, B, precision):
    rows, offs = F.coeff_rows_data()
    outs = []
    for fn in (tfb.svrg_coeff_multistep, tfb.svrg_coeff_multistep_ref):
        st = [t.clone() for t in state]
        fn(rows, offs, starts, canch, *st, av, sc, B, precision=precision,
           rs=F.coeff_rows_scale())
        outs.append(st)
    torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize("lam", [0.1, 0.0], ids=["l1", "zero"])
@pytest.mark.parametrize("storage,precision,n", [
    ("f32", "highest", 128), ("f32", "default", 128),
    ("bf16", "highest", 128), ("int8", "highest", 128),
    ("f32", "highest", 202), ("int8", "highest", 200),
], ids=["f32", "f32-default", "bf16", "int8", "f32-n202", "int8-n200"])
def test_svrg_kernel_matches_plain_version(dev, storage, precision, n, lam):
    """K = 64 inner steps at N = 8,192, B = 128 (repeats included); w and
    zs within 1e-6 of their largest entry for exact-f32 dots, 1e-5 where
    the dots round to bf16. λ = 0 is the Zero prox."""
    N, B, K = 8192, 128, 64
    F, canch, state, av, starts, sc = _svrg_setup(dev, N, n, B, K, storage,
                                                   lam)
    before = tfb.svrg_coeff_multistep.launches
    (kw, kzs), (rw, rzs) = _run_svrg(F, canch, state, av, starts, sc, B,
                                     precision)
    assert tfb.svrg_coeff_multistep.launches == before + 1
    tol = 1e-5 if tfb._lowp(F.A, precision) else 1e-6
    assert float((rw - state[0]).abs().max()) > 0
    assert _rel(kw, rw) <= tol
    assert _rel(kzs, rzs) <= tol


def test_svrg_kernel_repeats_bit_for_bit_and_checks_arguments(dev):
    F, canch, state, av, starts, sc = _svrg_setup(dev, 4096, 256, 256, 16,
                                                   "int8", 0.1, seed=1)
    rows, offs = F.coeff_rows_data()
    rs = F.coeff_rows_scale()
    runs = []
    for _ in range(2):
        st = [t.clone() for t in state]
        tfb.svrg_coeff_multistep(rows, offs, starts, canch, *st, av, sc, 256,
                                 rs=rs)
        runs.append(st)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    w, zs = state
    with pytest.raises(ValueError, match="scalars"):
        tfb.svrg_coeff_multistep(rows, offs, starts, canch, w, zs, av,
                                 torch.zeros(8, device=dev), 256, rs=rs)
    with pytest.raises(ValueError, match="canch"):
        tfb.svrg_coeff_multistep(rows, offs, starts, canch[:100], w, zs, av,
                                 sc, 256, rs=rs)
    with pytest.raises(ValueError, match="rs"):
        tfb.svrg_coeff_multistep(rows, offs, starts, canch, w, zs, av, sc,
                                 256)
    with pytest.raises(TypeError, match="starts"):
        tfb.svrg_coeff_multistep(rows, offs, starts.long(), canch, w, zs, av,
                                 sc, 256, rs=rs)


# ---------------------------------------------------------------------------
# kernel #6: coeff_apply_all
# ---------------------------------------------------------------------------

def _apply_both(A, b, z, sc, precision, rs):
    k = tfb.coeff_apply_all(A, b, z, sc, precision=precision, rs=rs)
    r = tfb.coeff_apply_all_ref(A, b, z, sc, precision=precision, rs=rs)
    torch.cuda.synchronize()
    return k, r


# the walk's cases: 8,192 x 256; the deep target's width n = 128, whose
# tiles hold 96 (f32), 192 (bf16) or 256 (int8) rows, with a ragged last
# tile; ragged N; rows that are not whole 16-byte chunks (the plain path);
# n = 4,096 (11 int8 rows a tile, the widest of the two-CTA walk) and the
# wide walk beyond (one CTA an SM: 2 f32 rows at n = 8,192, 2 bf16 rows at
# n = 16,384; its plain path at n = 8,200 int8)
APPLY_CASES = [
    ("f32", "highest", 8192, 256), ("f32", "default", 8192, 256),
    ("bf16", "highest", 8192, 256), ("int8", "highest", 8192, 256),
    ("f32", "highest", 65573, 128), ("f32", "default", 65573, 128),
    ("bf16", "highest", 65573, 128), ("int8", "highest", 65573, 128),
    ("f32", "highest", 8191, 202), ("int8", "highest", 8000, 200),
    ("int8", "highest", 4099, 4096), ("f32", "default", 1029, 8192),
    ("bf16", "highest", 517, 16384), ("int8", "highest", 1031, 8200),
]
APPLY_IDS = ["f32", "f32-default", "bf16", "int8", "f32-n128",
             "f32-default-n128", "bf16-n128", "int8-n128", "f32-ragged",
             "int8-n200", "int8-n4096", "f32-default-n8192", "bf16-n16384",
             "int8-n8200"]


def _apply_z(n, gen, dev):
    """The point of the walk's cases: 0.05 per entry up to n = 1,024, and
    scaled by sqrt(1024 / n) beyond, so that the margins of Gaussian rows
    keep the spread they have at n = 1,024 (a standard deviation of
    1.6)."""
    return 0.05 * min(1.0, (1024 / n) ** 0.5) * torch.randn(
        n, generator=gen, device=dev)


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4],
                         ids=["lsq", "logistic", "huber", "sqhinge",
                              "poisson"])
@pytest.mark.parametrize("storage,precision,N,n", APPLY_CASES, ids=APPLY_IDS)
def test_apply_kernel_matches_plain_version(dev, storage, precision, N, n,
                                            mode):
    """Every formula mode through the scalars row, tiles of more than 32
    rows with a ragged last tile, ragged N and rows that are not whole
    16-byte chunks: c within 1e-6 of its largest entry (1e-5 with bf16
    dots), gsum within 1e-5 (1e-4): both sum in other orders, and a
    margin that moves by an ulp can move a bf16-rounded coefficient by
    2^-8."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(mode)
    F = LeastSquaresRows(torch.randn(N, n, generator=gen, device=dev),
                         torch.randn(N, generator=gen, device=dev), float(N))
    if storage != "f32":
        F = F.with_storage(storage)
    rows, offs = F.coeff_rows_data()
    z = _apply_z(n, gen, dev)
    sc = torch.tensor([N if mode in (0, 2) else 1.0, mode, 0.5], device=dev)
    before = tfb.coeff_apply_all.launches
    (kc, kg), (rc, rg) = _apply_both(rows, offs, z, sc, precision,
                                     F.coeff_rows_scale())
    assert tfb.coeff_apply_all.launches == before + 1
    tol = 1e-5 if tfb._lowp(rows, precision) else 1e-6
    assert _rel(kc, rc) <= tol
    assert _rel(kg, rg) <= 10 * tol


def test_apply_kernel_compensates_and_repeats_bit_for_bit(dev):
    """tests/test_ops.py:367's adversarial stream (N = 262,144, n = 128:
    2,048 rows of c = 2^18, then 1e-3): the kernel's gsum[0] is within
    0.05·lost of the exact sum, and two runs give the same bits."""
    Np, npix, TILE = 262_144, 128, 2_048
    A = torch.zeros(Np, npix, device=dev)
    A[:, 0] = 1.0
    b = torch.full((Np,), -1e-3, device=dev)
    b[:TILE] = -(2.0 ** 18)
    sc = torch.tensor([1.0, 0.0, 0.0], device=dev)
    z = torch.zeros(npix, device=dev)
    exact = 2.0 ** 18 * TILE + 1e-3 * (Np - TILE)
    _, g1 = tfb.coeff_apply_all(A, b, z, sc)
    _, g2 = tfb.coeff_apply_all(A, b, z, sc)
    torch.cuda.synchronize()
    assert abs(float(g1[0]) - exact) < 0.05 * 1e-3 * (Np - TILE)
    assert torch.equal(g1, g2)


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_apply_kernels_repeat_and_agree_bit_for_bit(dev, storage):
    """At n = 128 (tiles of 96-256 rows, a ragged last tile): kernels #6
    and #7 each repeat bit for bit, and #7's c and gsum are #6's."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    N, n = 65573, 128
    F = LeastSquaresRows(torch.randn(N, n, generator=gen, device=dev),
                         torch.randn(N, generator=gen, device=dev), float(N))
    if storage != "f32":
        F = F.with_storage(storage)
    rows, b = F.coeff_rows_data()
    rs = F.coeff_rows_scale()
    z = 0.05 * torch.randn(n, generator=gen, device=dev)
    sc = torch.tensor([1.0, 1.0, 0.0], device=dev)
    b = torch.sign(b)
    six = [tfb.coeff_apply_all(rows, b, z, sc, rs=rs) for _ in range(2)]
    seven = [tfb.coeff_value_apply_all(rows, b, z, sc, rs=rs)
             for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*six))
    assert all(torch.equal(x, y) for x, y in zip(*seven))
    assert torch.equal(seven[0][1], six[0][0])
    assert torch.equal(seven[0][2], six[0][1])


@pytest.mark.parametrize("kernel", ["#6", "#7"])
def test_apply_kernels_take_a_misaligned_A(dev, kernel):
    """Rows that start 4 bytes past a 16-byte boundary take the plain path
    (no bulk copy): the kernel against its plain version at the bounds of
    test_apply_kernel_matches_plain_version."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    N, n = 4099, 128
    flat = torch.randn(N * n + 1, generator=gen, device=dev)
    A = flat[1:].view(N, n)
    assert A.data_ptr() % 16 == 4
    b = torch.randn(N, generator=gen, device=dev)
    z = 0.05 * torch.randn(n, generator=gen, device=dev)
    sc = torch.tensor([float(N), 0.0, 0.0], device=dev)
    fn, ref = ((tfb.coeff_apply_all, tfb.coeff_apply_all_ref)
               if kernel == "#6" else
               (tfb.coeff_value_apply_all, tfb.coeff_value_apply_all_ref))
    k, r = fn(A, b, z, sc), ref(A, b, z, sc)
    torch.cuda.synchronize()
    assert _rel(k[-2], r[-2]) <= 1e-6
    assert _rel(k[-1], r[-1]) <= 1e-5


def test_apply_wrapper_checks_its_arguments(dev):
    A = torch.randn(1024, 64, device=dev)
    b, z = torch.randn(1024, device=dev), torch.randn(64, device=dev)
    sc = torch.tensor([1.0, 0.0, 0.0], device=dev)
    with pytest.raises(ValueError, match="scalars"):
        tfb.coeff_apply_all(A, b, z, torch.zeros(8, device=dev))
    with pytest.raises(ValueError, match="z has shape"):
        tfb.coeff_apply_all(A, b, z[:32], sc)
    with pytest.raises(ValueError, match="on cpu"):
        tfb.coeff_apply_all(A, b.cpu(), z, sc)
    with pytest.raises(ValueError, match="rs"):
        tfb.coeff_apply_all(A.to(torch.int8), b, z, sc)


def test_svrg_and_fista_facades_run_on_the_kernels(dev):
    """On the card a block-sampling SVRG run takes kernel #5 for every
    inner step and kernel #6 for every anchor (none stepwise, no
    fallback warning, the SAGA kernels untouched), SVRG++ too across
    launch boundaries, and FISTA takes kernel #6 once per step; the
    objectives fall."""
    import warnings

    from ciao_tpu_torch import FISTA, SVRG
    from ciao_tpu_torch.monitor import objective
    from ciao_tpu_torch.prox import NormL1

    N, n, B = 4224, 64, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    A = torch.randn(N, n, generator=gen, device=dev)
    F = LeastSquaresRows(A, torch.randn(N, generator=gen, device=dev),
                         float(N))
    g = NormL1(torch.tensor(0.01, device=dev))
    x0 = torch.zeros(n, device=dev)
    L = (A * A).sum(1) * N
    gamma = 1.0 / (10.0 * float(L.max()))
    kernels = (tfb.svrg_coeff_multistep, tfb.coeff_apply_all,
               tfb.saga_coeff_multistep, tfb.saga_coeff_multistep_streamed)
    before = [k.launches for k in kernels]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        x, it = SVRG(maxit=5, gamma=gamma, m=200, block_sampling=True,
                     batch=B)(x0, F=F, g=g)
    assert it == 5
    # 4 outer steps of 200 inner steps: 128 + 72 each; 4 anchors
    assert [k.launches - b for k, b in zip(kernels, before)] == [8, 4, 0, 0]
    assert float(objective(F, g, x)) < float(objective(F, g, x0))
    before = [k.launches for k in kernels]
    x, it = SVRG(maxit=4, gamma=gamma, m=100, plus=True, block_sampling=True,
                 batch=B)(x0, F=F, g=g)
    # m = 100, 200, 400: 1 + 2 + 4 launches
    assert [k.launches - b for k, b in zip(kernels, before)] == [7, 3, 0, 0]
    before = [k.launches for k in kernels]
    x, it = FISTA(maxit=51)(x0, F=F, g=g, L=L)
    assert [k.launches - b for k, b in zip(kernels, before)] == [0, 50, 0, 0]
    assert float(objective(F, g, x)) < float(objective(F, g, x0))


# ---------------------------------------------------------------------------
# kernels #9, #14, #8, #2: the Finito family
# ---------------------------------------------------------------------------

def _finito_setup(dev, N, n, B, K, storage, lam, seed=0, distinct=False):
    """A Finito coefficient state on the card: c at a point x0, per-block
    anchors zb near it, av of the identity hat·(invg @ zb − apply_all(c)/N),
    z = soft(av, hat·λ); K block starts (repeats included unless
    ``distinct``); scalars [scale, 1/N, hat, hat·λ, mode, aux]."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    A = torch.randn(N, n, generator=gen, device=dev)
    F = LeastSquaresRows(A, torch.randn(N, generator=gen, device=dev),
                         float(N))
    if storage != "f32":
        F = F.with_storage(storage)
    d = N // B
    gamma = 0.999 * N / ((A * A).sum(1) * N)
    hat = float(1.0 / (1.0 / gamma).sum())
    invg = (1.0 / gamma).reshape(d, B).sum(1)
    x0 = 0.05 * torch.randn(n, generator=gen, device=dev)
    zb = x0 + 0.01 * torch.randn(d, n, generator=gen, device=dev)
    c = F.coeff_all(x0)
    av = hat * (invg @ zb) - hat / N * F.apply_all(c)
    z = torch.sign(av) * torch.clamp(av.abs() - hat * lam, min=0.0)
    blocks = (torch.randperm(d, generator=gen, device=dev)[:K] if distinct
              else torch.randint(d, (K,), generator=gen, device=dev))
    sc = torch.tensor([N, 1.0 / N, hat, hat * lam, 0.0, 0.0], device=dev)
    return F, (c, zb, z, av), (blocks * B).to(torch.int32), invg, gamma, sc


def _finito_both(F, state, starts, invg, sc, B, precision, streamed=False,
                 f=None):
    rows, offs = F.coeff_rows_data()
    rs = F.coeff_rows_scale()
    outs = []
    fns = ((tfb.finito_coeff_multistep_streamed,
            tfb.finito_coeff_multistep_streamed_ref) if streamed else
           (tfb.finito_coeff_multistep, tfb.finito_coeff_multistep_ref))
    for fn in fns:
        c, zb, z, av = (t.clone() for t in state)
        if streamed:
            fn(rows, offs, starts, invg[starts.long() // B], c, zb, z, av,
               sc, B, precision=precision, rs=rs, f=f)
        else:
            fn(rows, offs, starts, c, zb, invg, z, av, sc, B,
               precision=precision, rs=rs)
        outs.append((c, zb, z, av))
    torch.cuda.synchronize()
    return outs


FINITO_CASES = [("f32", "highest", 256), ("f32", "default", 256),
                ("bf16", "highest", 256), ("int8", "highest", 256),
                ("f32", "highest", 202), ("int8", "highest", 200)]
FINITO_IDS = ["f32", "f32-default", "bf16", "int8", "f32-n202", "int8-n200"]


@pytest.mark.parametrize("lam", [0.1, 0.0], ids=["l1", "zero"])
@pytest.mark.parametrize("storage,precision,n", FINITO_CASES, ids=FINITO_IDS)
def test_finito_kernel_matches_plain_version(dev, storage, precision, n,
                                             lam):
    """Kernel #9: K = 32 steps at N = 4,096, B = 256 with repeated blocks;
    z within 1e-6 of its largest entry (1e-5 with bf16 dots), c, zb and
    av within 10x that."""
    N, B, K = 4096, 256, 32
    F, state, starts, invg, _, sc = _finito_setup(dev, N, n, B, K, storage,
                                                  lam)
    before = tfb.finito_coeff_multistep.launches
    (kc, kzb, kz, kav), (rc, rzb, rz, rav) = _finito_both(
        F, state, starts, invg, sc, B, precision)
    assert tfb.finito_coeff_multistep.launches == before + 1
    tol = 1e-5 if tfb._lowp(F.A, precision) else 1e-6
    assert float((rz - state[2]).abs().max()) > 0
    assert _rel(kz, rz) <= tol
    for k, r in ((kc, rc), (kzb, rzb), (kav, rav)):
        assert _rel(k, r) <= 10 * tol


@pytest.mark.parametrize("f", [64, 23], ids=["f=K", "f=23"])
@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_finito_streamed_kernel_matches_plain_version(dev, storage, f):
    """Kernel #14: K = 64 distinct blocks at N = 8,192, n = 128, B = 128
    (d = 64), clamp count f on the device, Σ 1/γ pre-gathered by step;
    the masked steps leave c, zb, z and av bit for bit as step f − 1 left
    them, and f = 0 leaves the state as it was."""
    N, n, B, K = 8192, 128, 128, 64
    F, state, starts, invg, _, sc = _finito_setup(dev, N, n, B, K, storage,
                                                  0.1, seed=2, distinct=True)
    fc = torch.tensor([f], dtype=torch.int32, device=dev)
    before = tfb.finito_coeff_multistep_streamed.launches
    kern, ref = _finito_both(F, state, starts, invg, sc, B, "highest",
                             streamed=True, f=fc)
    assert tfb.finito_coeff_multistep_streamed.launches == before + 1
    tol = 1e-5 if tfb._lowp(F.A, "highest") else 1e-6
    assert _rel(kern[2], ref[2]) <= tol
    for k, r in zip(kern, ref):
        assert _rel(k, r) <= 10 * tol
    rows, offs = F.coeff_rows_data()

    def run(st, fc_):
        out = [t.clone() for t in state]
        tfb.finito_coeff_multistep_streamed(
            rows, offs, st, invg[st.long() // B], *out, sc, B,
            rs=F.coeff_rows_scale(), f=fc_)
        torch.cuda.synchronize()
        return out
    for a, b in zip(run(starts, fc), run(starts[:f], None)):
        assert torch.equal(a, b)
    for a, b in zip(run(starts, torch.zeros(1, dtype=torch.int32,
                                            device=dev)), state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lam", [0.1, 0.0], ids=["l1", "zero"])
@pytest.mark.parametrize("storage,precision,n", FINITO_CASES, ids=FINITO_IDS)
def test_lfinito_kernel_matches_plain_version(dev, storage, precision, n,
                                              lam):
    """Kernel #8: a whole shuffled sweep of d = 16 blocks at N = 4,096,
    B = 256 against the epoch's anchor; av and the returned z within the
    tolerances of kernel #9; z is the last block's prox point, and a
    sweep in chunks of 5 gives the same bits."""
    N, B = 4096, 256
    F, (c, zb, z, av), starts, invg, _, sc9 = _finito_setup(
        dev, N, n, B, 16, storage, lam, seed=4, distinct=True)
    hat = float(sc9[2])
    sc = torch.tensor([N, hat, hat * lam, 1.0 / N, 0.0, 0.0], device=dev)
    rows, offs = F.coeff_rows_data()
    rs = F.coeff_rows_scale()
    canch = F.coeff_all(z)
    av0 = z - hat / N * F.apply_all(canch)
    iv = invg[starts.long() // B].contiguous()
    before = tfb.lfinito_sweep_multistep.launches
    kav, kz = tfb.lfinito_sweep_multistep(rows, offs, canch, starts,
                                          av0.clone(), z, iv, sc, B,
                                          precision=precision, rs=rs)
    rav, rz = tfb.lfinito_sweep_multistep_ref(rows, offs, canch, starts,
                                              av0.clone(), z, iv, sc, B,
                                              precision=precision, rs=rs)
    cav, cz = tfb.lfinito_sweep_chunked(rows, offs, canch, starts, iv,
                                        av0.clone(), z, sc, B,
                                        precision=precision, rs=rs, chunk=5)
    torch.cuda.synchronize()
    assert tfb.lfinito_sweep_multistep.launches == before + 5
    tol = 1e-5 if tfb._lowp(F.A, precision) else 1e-6
    assert _rel(kz, rz) <= tol and _rel(kav, rav) <= 10 * tol
    assert torch.equal(cav, kav) and torch.equal(cz, kz)
    if lam:
        assert not torch.equal(
            kz, torch.sign(kav) * torch.clamp(kav.abs() - hat * lam, min=0))


@pytest.mark.parametrize("storage,precision,n", [
    ("f32", "highest", 256), ("f32", "default", 256),
    ("bf16", "highest", 256), ("bf16", "default", 256),
    ("f32", "highest", 202), ("bf16", "highest", 200),
], ids=["f32", "f32-default", "bf16", "bf16-default", "f32-n202",
        "bf16-n200"])
def test_finito_block_kernel_matches_plain_version(dev, storage, precision,
                                                   n):
    """Kernel #2 on the block at rows 1,024-1,279 of N = 4,096 (the start
    a device tensor): s over the block and the innovation within 1e-6 of
    their largest entries (1e-5 with bf16 dots); every other row of s bit
    for bit as it was."""
    N, B, start = 4096, 256, 1024
    F, (_, _, z, _), _, _, gamma, _ = _finito_setup(dev, N, n, B, 1, storage,
                                                    0.1, seed=5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    s = torch.randn(N, n, generator=gen, device=dev)
    sc = torch.tensor([N, 1.0 / N, 0.37], device=dev)
    rows, offs = F.coeff_rows_data()
    st = torch.tensor(start, dtype=torch.int32, device=dev)
    before = tfb.finito_block_update.launches
    ks, kin = tfb.finito_block_update(rows, offs, s.clone(), gamma, z, st,
                                      sc, B, precision=precision)
    rs_, rin = tfb.finito_block_update_ref(rows, offs, s.clone(), gamma, z,
                                           start, sc, B, precision=precision)
    torch.cuda.synchronize()
    assert tfb.finito_block_update.launches == before + 1
    tol = 1e-5 if precision == "default" else 1e-6
    blk = slice(start, start + B)
    assert _rel(ks[blk], rs_[blk]) <= tol and _rel(kin, rin) <= 10 * tol
    assert torch.equal(ks[:start], s[:start])
    assert torch.equal(ks[start + B:], s[start + B:])
    with pytest.raises(TypeError, match="int8"):
        tfb.finito_block_update(rows.to(torch.int8), offs, s, gamma, z, 0,
                                sc, B)
    with pytest.raises(ValueError, match="multiple"):
        tfb.finito_block_update(rows, offs, s, gamma, z, 100, sc, B)


def test_finito_facade_sends_every_gated_run_to_a_kernel(dev, monkeypatch):
    """On the card each Finito run whose gate is open takes its kernels,
    the remainder included, with no fallback warning: the coefficient
    table #9 (and #14 past a lowered resident bound), the full table #2
    once a step, LFinito #6 and #8 once an epoch, adaptive none; the
    objectives fall."""
    import warnings

    from ciao_tpu_torch import Finito
    from ciao_tpu_torch.monitor import objective
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers import finito as tfin

    N, n, B = 4096, 64, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    A = torch.randn(N, n, generator=gen, device=dev)
    F = LeastSquaresRows(A, torch.randn(N, generator=gen, device=dev),
                         float(N))
    g = NormL1(torch.tensor(0.01, device=dev))
    x0 = torch.zeros(n, device=dev)
    L = (A * A).sum(1) * N
    kernels = ("finito_coeff_multistep", "finito_coeff_multistep_streamed",
               "finito_block_update", "lfinito_sweep_multistep",
               "coeff_apply_all", "saga_coeff_multistep")
    cases = [(dict(sweeping=3, maxit=201), [2, 0, 0, 0, 0, 0]),
             (dict(sweeping=3, maxit=201, stream=True), [0, 2, 0, 0, 0, 0]),
             (dict(sweeping=2, maxit=21, table="full"), [0, 0, 20, 0, 0, 0]),
             (dict(sweeping=3, maxit=5, LFinito=True), [0, 0, 0, 4, 4, 0]),
             (dict(sweeping=1, maxit=4, minibatch=(True, 1), adaptive=True),
              [0] * 6)]
    for kw, want in cases:
        stream = kw.pop("stream", False)
        kw.setdefault("minibatch", (True, B))
        before = [getattr(tfb, k).launches for k in kernels]
        with monkeypatch.context() as m:
            if stream:
                m.setattr(tfin, "RESIDENT_MAX_ROWS", N // 2)
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                x, it = Finito(**kw)(x0, F=F, g=g, L=L)
        assert it == kw["maxit"]
        assert [getattr(tfb, k).launches - b
                for k, b in zip(kernels, before)] == want, kw
        assert float(objective(F, g, x)) < float(objective(F, g, x0)), kw


# ---------------------------------------------------------------------------
# kernels #1 and #18: SAGA's full table and ProShI's block table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage,precision,n", [
    ("f32", "highest", 256), ("f32", "default", 256),
    ("bf16", "highest", 256), ("bf16", "default", 256),
    ("f32", "highest", 202), ("bf16", "highest", 200),
], ids=["f32", "f32-default", "bf16", "bf16-default", "f32-n202",
        "bf16-n200"])
def test_saga_block_kernel_matches_plain_version(dev, storage, precision, n):
    """Kernel #1 on the block at rows 1,024-1,279 of N = 4,096 (the start
    a device tensor): the block's rows and the innovation within 1e-6 of
    their largest entries (1e-5 with bf16 dots); every other row bit for
    bit as it was; int8 rows and a misaligned start raise."""
    N, B, start = 4096, 256, 1024
    F, (_, z, _), _, _, _ = _setup(dev, N, n, B, 1, storage, False, False,
                                   seed=8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    s = torch.randn(N, n, generator=gen, device=dev)
    sc = torch.tensor([float(N)], device=dev)
    rows, offs = F.coeff_rows_data()
    st = torch.tensor(start, dtype=torch.int32, device=dev)
    before = tfb.saga_block_update.launches
    ks, kin = tfb.saga_block_update(rows, offs, s.clone(), z, st, sc, B,
                                    precision=precision)
    rs_, rin = tfb.saga_block_update_ref(rows, offs, s.clone(), z, start, sc,
                                         B, precision=precision)
    torch.cuda.synchronize()
    assert tfb.saga_block_update.launches == before + 1
    tol = 1e-5 if precision == "default" else 1e-6
    blk = slice(start, start + B)
    assert _rel(ks[blk], rs_[blk]) <= tol and _rel(kin, rin) <= 10 * tol
    assert torch.equal(ks[:start], s[:start])
    assert torch.equal(ks[start + B:], s[start + B:])
    with pytest.raises(TypeError, match="int8"):
        tfb.saga_block_update(rows.to(torch.int8), offs, s, z, 0, sc, B)
    with pytest.raises(ValueError, match="multiple"):
        tfb.saga_block_update(rows, offs, s, z, 100, sc, B)


def _proshi_setup(dev, N, n, B, K, storage, gname, seed=0):
    """A ProShI state and K block starts on the card, the scalars row by
    ``solvers.proshi._scalars_row``."""
    import math

    from ciao_tpu_torch.prox import IndBox, NormL1, Zero
    from ciao_tpu_torch.sampling import init_sweep
    from ciao_tpu_torch.solvers.proshi import (
        ProshiCfg, ProshiState, _coupling, _scalars_row,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    F = LeastSquaresRows(torch.randn(N, n, generator=gen, device=dev),
                         torch.randn(N, generator=gen, device=dev), float(N))
    if storage != "f32":
        F = F.with_storage(storage)
    g = {"box": IndBox(-math.inf, 1.0), "l1": NormL1(0.1),
         "zero": Zero()}[gname].to(dev)
    gamma = 0.999 / (n * (0.8 + 0.4 * torch.rand(N, generator=gen,
                                                   device=dev)))
    s = 0.05 * torch.randn(N, n, generator=gen, device=dev)
    av, hat = s.sum(0), gamma.sum()
    st = ProshiState(s=s, gamma=gamma, hat_gamma=hat, av=av,
                     z=_coupling(g, av, hat), sweep=init_sweep(0, N, B, 2, dev),
                     it=1, status=0)
    starts = (torch.randint(N // B, (K,), generator=gen, device=dev) * B).to(
        torch.int32)
    sc = _scalars_row(F, g, st, ProshiCfg(N=N, batch=B, sweeping=2,
                                          alpha=0.999))
    return F, st, starts, sc


def _proshi_run(fn, F, st, starts, sc, B, precision="highest", f=None):
    rows, offs = F.coeff_rows_data()
    out = [t.clone() for t in (st.s, st.av, st.z)]
    fn(rows, offs, st.gamma, out[0], starts, out[1], out[2], sc, B,
       precision=precision, rs=F.coeff_rows_scale(), f=f)
    return out


@pytest.mark.parametrize("gname", ["box", "l1", "zero"])
@pytest.mark.parametrize("storage,n", [
    ("f32", 256), ("bf16", 256), ("int8", 256), ("f32", 202), ("int8", 200),
], ids=["f32", "bf16", "int8", "f32-n202", "int8-n200"])
def test_proshi_kernel_matches_plain_version(dev, storage, n, gname):
    """Kernel #18, 24 steps at N = 4,096, B = 256 (repeated blocks): s,
    av and z within 1e-6 of their largest entries (the margins are exact
    f32 with any rows); "default" precision gives the same result bit for
    bit (the Pallas kernel ignores it too)."""
    F, st, starts, sc = _proshi_setup(dev, 4096, n, 256, 24, storage, gname)
    before = tfb.proshi_multistep.launches
    kern = _proshi_run(tfb.proshi_multistep, F, st, starts, sc, 256)
    low = _proshi_run(tfb.proshi_multistep, F, st, starts, sc, 256, "default")
    ref = _proshi_run(tfb.proshi_multistep_ref, F, st, starts, sc, 256)
    torch.cuda.synchronize()
    assert tfb.proshi_multistep.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(kern, low))
    assert float((ref[0] - st.s).abs().max()) > 0
    for k, r in zip(kern, ref):
        assert _rel(k, r) <= 1e-6
    if gname == "zero":
        assert not bool(kern[2].any())


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_proshi_masked_steps_are_identity(dev, storage):
    """Kernel #18 clamped at f = 9 of K = 24 leaves s, av and z bit for bit
    as the first 9 steps alone leave them; f = 0 leaves them as they
    were; a bad count raises."""
    F, st, starts, sc = _proshi_setup(dev, 4096, 256, 256, 24, storage, "box",
                                      seed=3)
    i32 = dict(dtype=torch.int32, device=dev)
    got = _proshi_run(tfb.proshi_multistep, F, st, starts, sc, 256,
                      f=torch.tensor([9], **i32))
    want = _proshi_run(tfb.proshi_multistep, F, st, starts[:9], sc, 256)
    zero = _proshi_run(tfb.proshi_multistep, F, st, starts, sc, 256,
                       f=torch.tensor(0, **i32))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(zero, (st.s, st.av, st.z)))
    with pytest.raises(ValueError, match="one count"):
        _proshi_run(tfb.proshi_multistep, F, st, starts, sc, 256,
                    f=torch.tensor([1, 2], **i32))


def test_proshi_and_full_table_facades_run_on_the_kernels(dev):
    """On the card the Proshi facade with a contiguous schedule runs on
    kernel #18 (LAUNCH_STEPS steps a call, the remainder a short call)
    and SAGA/SAG with table="full" on kernel #1 once a step, with no
    fallback warning; the random sweep without block sampling warns and
    runs stepwise; the objectives fall."""
    import math
    import warnings

    from ciao_tpu_torch import SAG, SAGA, Proshi
    from ciao_tpu_torch.monitor import objective, sharing_objective
    from ciao_tpu_torch.prox import IndBox, NormL1
    from ciao_tpu_torch import runtime

    N, n, B = 4096, 64, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    A = torch.randn(N, n, generator=gen, device=dev)
    F = LeastSquaresRows(A, torch.randn(N, generator=gen, device=dev),
                         float(N))
    L = (A * A).sum(1) * N
    x0 = torch.zeros(n, device=dev)
    gb = IndBox(-math.inf, 1.0)
    blocks0 = x0[None, :].expand(N, n)
    for kw, want in ((dict(sweeping=2, maxit=201), 2),
                     (dict(sweeping=3, maxit=130), 2),
                     (dict(sweeping=1, block_sampling=True, maxit=65), 1)):
        before = tfb.proshi_multistep.launches
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            x, it = Proshi(minibatch=(True, B), **kw)(x0, F=F, g=gb, L=L)
        assert it == kw["maxit"]
        assert tfb.proshi_multistep.launches - before == want, kw
        assert float(sharing_objective(F, gb, x)) < float(
            sharing_objective(F, gb, blocks0))
    runtime.reset_fallback_warnings()
    before = tfb.proshi_multistep.launches
    with pytest.warns(UserWarning, match="contiguous-block stream"):
        Proshi(minibatch=(True, B), sweeping=1, maxit=5)(x0, F=F, g=gb, L=L)
    assert tfb.proshi_multistep.launches == before
    runtime.reset_fallback_warnings()
    g = NormL1(torch.tensor(0.01, device=dev))
    for solver in (SAGA(maxit=41, table="full", block_sampling=True,
                        batch=B),
                   SAG(maxit=41, table="full", block_sampling=True,
                       batch=B)):
        before = tfb.saga_block_update.launches
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            x, it = solver(x0, F=F, g=g, L=L)
        assert tfb.saga_block_update.launches - before == it - 1 == 40
        assert float(objective(F, g, x)) < float(objective(F, g, x0))
    with pytest.warns(UserWarning, match="full-table"):
        SAGA(maxit=3, table="full", block_sampling=True, batch=B)(
            x0, F=F.with_storage("int8"), g=g, L=L)
    runtime.reset_fallback_warnings()


# ---------------------------------------------------------------------------
# kernels #10, #11, #16, #17: Katyusha, SARAH, L-SVRG and L-Katyusha
# ---------------------------------------------------------------------------

def _vr_setup(dev, N, n, B, K, storage, mode=0, seed=0):
    """Rows, an anchor point and its coefficients, av their mean gradient,
    two points near the anchor and K block starts (repeats included). For
    the logistic mode the offsets are ±1 labels."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    A = torch.randn(N, n, generator=gen, device=dev)
    b = torch.randn(N, generator=gen, device=dev)
    if mode == 1:
        b = torch.sign(b)
    F = LeastSquaresRows(A, b, float(N))
    if storage != "f32":
        F = F.with_storage(storage)
    # the rows' smoothness: scale·‖a_i‖², a quarter of ‖a_i‖² for logistic
    Lmax = float((A * A).sum(1).max()) * (0.25 if mode == 1 else N)
    xa = 0.05 * torch.randn(n, generator=gen, device=dev)
    near = xa + 0.01 * torch.randn(2, n, generator=gen, device=dev)
    starts = (torch.randint(N // B, (K,), generator=gen, device=dev) * B).to(
        torch.int32)
    rows, offs = F.coeff_rows_data()
    sc = torch.tensor([N if mode != 1 else 1.0, mode, 0.5], device=dev)
    canch, gsum = tfb.coeff_apply_all_ref(rows, offs, xa, sc,
                                          rs=F.coeff_rows_scale())
    return dict(F=F, rows=rows, offs=offs, rs=F.coeff_rows_scale(),
                Lmax=Lmax, xa=xa, near=near, starts=starts, canch=canch,
                av=gsum / N, scale=float(sc[0]), mode=mode)


def _vr_scalars(S, kind, B, lam, dev):
    """The scalars row of ``kind`` with the setup's formula mode (aux =
    0.5, the Huber δ) at its slot."""
    L, sc, md = S["Lmax"], S["scale"], S["mode"]
    if kind == "katyusha":
        t1, t2 = 0.3, 0.5
        a, be = 1.0 / (3.0 * t1 * L), 1.0 / (3.0 * L)
        row = [sc, a, be, a * lam, be * lam, 1.0 / B, md, t1, t2, 0.5]
    elif kind == "sarah":
        g = 1.0 / (2.0 * L)
        row = [sc, g, g * lam, 0.7, 1.0 / B, md, 0.5]
    elif kind == "lsvrg":
        g = 1.0 / (6.0 * L)
        row = [sc, g, g * lam, 1.0 / B, md, 0.5]
    else:
        th1, th2, sig = 1.0 / 3.0, 0.5, 0.01
        eta = th2 / ((1.0 + th2) * th1)
        step, den = eta / L, 1.0 + eta * sig
        row = [sc, step, step / den * lam, 1.0 / den, eta * sig, th1, th2,
               1.0 / B, md, 0.5]
    return torch.tensor(row, device=dev)


def _vr_run(kind, fn, S, sc, B, precision="highest", stop=None, starts=None):
    """One call of ``fn`` (kernel #10, #11, #16 or #17, or its plain
    version) from fresh copies of the setup's state; returns its outputs."""
    starts = S["starts"] if starts is None else starts
    a, p, q = S["xa"], S["near"][0].clone(), S["near"][1].clone()
    common = dict(precision=precision, rs=S["rs"])
    rows, offs, canch, av = S["rows"], S["offs"], S["canch"], S["av"]
    if kind == "katyusha":
        ys = torch.zeros_like(p)
        return fn(rows, offs, canch, starts, a, p, q, ys, av, sc, B, **common)
    if kind == "sarah":
        v = av.clone()
        return fn(rows, offs, starts, torch.stack([a, p]), v, sc, B, **common)
    if kind == "lsvrg":
        return fn(rows, offs, canch, starts, stop, p, av, sc, B, **common)
    return fn(rows, offs, canch, starts, stop, a, p, q, av, sc, B, **common)


VR_KERNELS = {
    "katyusha": ("katyusha_coeff_multistep", "katyusha_coeff_multistep_ref"),
    "sarah": ("sarah_multistep", "sarah_multistep_ref"),
    "lsvrg": ("lsvrg_coeff_multistep", "lsvrg_coeff_multistep_ref"),
    "lkatyusha": ("lkatyusha_coeff_multistep",
                  "lkatyusha_coeff_multistep_ref"),
}


# (storage, precision, n, mode, λ, N, B, K, stop) of every kernel: K = 64
# steps at N = 8,192, B = 128
VR_CASES = {
    "f32": ("f32", "highest", 128, 0, 0.1), "f32-default": ("f32", "default",
                                                          128, 0, 0.1),
    "bf16": ("bf16", "highest", 128, 0, 0.1), "int8": ("int8", "highest", 128,
                                                        0, 0.1),
    "zero": ("f32", "highest", 128, 0, 0.0), "f32-n202": ("f32", "highest",
                                                          202, 0, 0.1),
    "int8-n200": ("int8", "highest", 200, 0, 0.1),
    "logistic": ("f32", "highest", 128, 1, 0.1),
    "huber": ("f32", "highest", 128, 2, 0.1)}
VR_SMALL = (8192, 128, 64, None)
# the engine's grid at width: 128 CTAs at B = 4,096 and 1,024 (32 and 8 rows
# a CTA, four f32 stages a step at B = 4,096), K = 32 with and without a stop
# (the loopless pair's); n = 16,384 (one f32 row a stage, two stages, the
# wide build; SARAH's f32 rows there take the one-stage ring)
LOOPLESS_CASES = {
    "B4096": ("f32", "highest", 1024, 0, 0.1, 32768, 4096, 32, None),
    "B4096-stop": ("f32", "highest", 1024, 0, 0.1, 32768, 4096, 32, 20),
    "B4096-int8-stop": ("int8", "highest", 1024, 0, 0.1, 32768, 4096, 32, 20),
    "B4096-bf16": ("bf16", "highest", 1024, 0, 0.1, 32768, 4096, 32, None),
    "B1024": ("f32", "highest", 1024, 0, 0.1, 32768, 1024, 32, None),
    "B1024-stop": ("f32", "highest", 1024, 0, 0.1, 32768, 1024, 32, 20),
    "B1024-int8": ("int8", "highest", 1024, 0, 0.1, 32768, 1024, 32, None),
    "n16384": ("f32", "highest", 16384, 0, 0.1, 8192, 1024, 8, None),
    "n16384-int8-stop": ("int8", "highest", 16384, 0, 0.1, 8192, 1024, 8, 5)}
# Katyusha and SARAH take no stop: their cases at width are the same
# without it, each once
WIDE_CASES = {cid.replace("-stop", ""): case[:-1] + (None,)
              for cid, case in LOOPLESS_CASES.items()}
VR_PARAMS = ([(kind, *case, *VR_SMALL) for case in VR_CASES.values()
              for kind in VR_KERNELS]
             + [(kind, *case) for case in LOOPLESS_CASES.values()
                for kind in ("lsvrg", "lkatyusha")]
             + [(kind, *case) for case in WIDE_CASES.values()
                for kind in ("katyusha", "sarah")])
VR_IDS = ([f"{cid}-{kind}" for cid in VR_CASES for kind in VR_KERNELS]
          + [f"{cid}-{kind}" for cid in LOOPLESS_CASES
             for kind in ("lsvrg", "lkatyusha")]
          + [f"{cid}-{kind}" for cid in WIDE_CASES
             for kind in ("katyusha", "sarah")])


@pytest.mark.parametrize("kind,storage,precision,n,mode,lam,N,B,K,stop",
                         VR_PARAMS, ids=VR_IDS)
def test_vr_kernel_matches_plain_version(dev, kind, storage, precision, n,
                                         mode, lam, N, B, K, stop):
    """K = 64 steps at N = 8,192, B = 128 (repeats included) of kernels
    #10, #11, #16 and #17 against their plain versions: every output
    within 1e-6 of its largest entry for exact-f32 dots, 1e-5 where the
    dots round to bf16 (SARAH's estimator v, a gradient mean, within 10x
    that, as av elsewhere). The logistic and Huber modes check the mode
    and aux slots of each scalars row; λ = 0 is the Zero prox. All four
    also at the persistent engine's width (LOOPLESS_CASES, the loopless
    pair with and without a stop): B = 4,096 and 1,024 at n = 1,024, K =
    32, and n = 16,384 (SARAH's one-stage ring at f32)."""
    S = _vr_setup(dev, N, n, B, K, storage, mode)
    sc = _vr_scalars(S, kind, B, lam, dev)
    kname, rname = VR_KERNELS[kind]
    st = None if stop is None else torch.tensor([stop], dtype=torch.int32,
                                                device=dev)
    before = getattr(tfb, kname).launches
    got = _vr_run(kind, getattr(tfb, kname), S, sc, B, precision, stop=st)
    want = _vr_run(kind, getattr(tfb, rname), S, sc, B, precision, stop=st)
    torch.cuda.synchronize()
    assert getattr(tfb, kname).launches == before + 1
    tol = 1e-5 if tfb._lowp(S["rows"], precision) else 1e-6
    assert float((want[0] - S["near"][0]).abs().max()) > 0
    for i, (k, r) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(k).all())
        bound = 10 * tol if (kind == "sarah" and i == 1) else tol
        assert _rel(k, r) <= bound, (kind, i, _rel(k, r))


# sha256 (first 16 hex digits) of the kernels' outputs on loopless_digest's
# inputs: #16's and #17's from the engine as it was before kernels #4 and #5
# joined it, #10's and #11's, #9's and #8's, #14's and #18's, #3's and
# #12's (logistic rows: the Newton solves pinned), and #19's, from their
# first builds on it (NVIDIA H100 80GB HBM3, 132 SMs, nvcc of CUDA 12.8).
# #14 on these block-aligned starts, with Σ 1/γ by step equal to #9's by
# block, gives #9's bits; #4 with no clamp count gives #3's, #13 #19's
LOOPLESS_GOLDEN = {
    ("lsvrg", "f32"): "1b86d247d1dd5e39",
    ("lsvrg", "int8"): "de61e002d1d466f6",
    ("lkatyusha", "f32"): "207eb3a290eead61",
    ("lkatyusha", "int8"): "b909aff2bb48f3dd",
    ("katyusha", "f32"): "69bdf9bba8171166",
    ("katyusha", "int8"): "7c30a0e6ba001d47",
    ("sarah", "f32"): "b6b32b4e8d5f0124",
    ("sarah", "int8"): "dbc4a187df664d4c",
    ("finito", "f32"): "1161747bc93e7414",
    ("finito", "int8"): "5c47bfd9bea3fcee",
    ("lfinito", "f32"): "b14d13c974849feb",
    ("lfinito", "int8"): "5c9cfa7975dabd22",
    ("finito_stream", "f32"): "1161747bc93e7414",
    ("finito_stream", "int8"): "5c47bfd9bea3fcee",
    ("proshi", "f32"): "452f551559aa9555",
    ("proshi", "int8"): "f2a1747b4ed2372d",
    ("saga", "f32"): "61b8cce2415ff7bb",
    ("saga", "int8"): "b5f33c250208d47b",
    ("point_saga", "f32"): "04fa23c347303456",
    ("point_saga", "int8"): "3765bc8958ce2316",
    ("ssnm", "f32"): "c88efc20cf5bbcf6",
    ("ssnm", "int8"): "09b4128dd7a0f0cb",
}


def loopless_digest(dev, kind, storage):
    """Kernel #16's (w, wpre), #17's (y, z, ypre), #10's (y, z, ys),
    #11's (ww, v), #9's or #14's (c, zb, z, av), #8's (av, z), #18's (s,
    av, z), #3's or #4's ("saga_stream", no clamp count) (c, z, av),
    #12's or #15's ("point_saga_stream", no clamp count) (c, x, av;
    logistic rows, labels sign(b), γ‖a_i‖² about 0.75) or #19's or #13's
    ("ssnm_stream", no clamp count) (c, zb, x, gb; τ =
    0.5) after one call of K = 32 steps at the headline width (N =
    32,768, n = 1,024, B = 4,096: 128 CTAs on a card of 132 SMs; the
    blocks revisited every eight steps) on exact dyadic inputs (no
    generator, no libm), as a digest."""
    import hashlib

    N, n, B, K = 32768, 1024, 4096, 32
    A, b, z, rs = _golden_inputs(dev, storage, N, n)
    i, j = torch.arange(N), torch.arange(n)
    canch = ((i * 5 % 23 - 11).float() / 32).to(dev)
    av = ((j * 3 % 13 - 6).float() / 1024).to(dev)
    y = ((j * 5 % 7 - 3).float() / 128).to(dev)
    starts = (torch.arange(K) * 5 % 8 * B).to(torch.int32).to(dev)
    if kind == "lsvrg":
        sc = torch.tensor([1.0, 2.0**-12, 2.0**-18, 1.0 / B, 0.0, 0.5],
                          device=dev)
        out = tfb.lsvrg_coeff_multistep(A, b, canch, starts, None, z.clone(),
                                        av, sc, B, rs=rs)
    elif kind == "katyusha":
        sc = torch.tensor([1.0, 2.0**-12, 2.0**-13, 2.0**-18, 2.0**-19,
                           1.0 / B, 0.0, 0.25, 0.5, 0.5], device=dev)
        out = tfb.katyusha_coeff_multistep(A, b, canch, starts, z, y.clone(),
                                           z.clone(), torch.zeros_like(z), av,
                                           sc, B, rs=rs)
    elif kind == "sarah":
        sc = torch.tensor([1.0, 2.0**-12, 2.0**-18, 0.75, 1.0 / B, 0.0, 0.5],
                          device=dev)
        out = tfb.sarah_multistep(A, b, starts, torch.stack([z, y]),
                                  av.clone(), sc, B, rs=rs)
    elif kind in ("finito", "finito_stream"):
        d = N // B
        zb = ((torch.arange(d)[:, None] * 3 + j * 5) % 17 - 8).float() / 512
        invg = ((torch.arange(d) % 3 + 4).float() * 128).to(dev)
        sc = torch.tensor([1.0, 1.0 / N, 2.0**-12, 2.0**-18, 0.0, 0.5],
                          device=dev)
        if kind == "finito":
            out = tfb.finito_coeff_multistep(A, b, starts, canch.clone(),
                                             zb.to(dev), invg, z.clone(),
                                             av.clone(), sc, B, rs=rs)
        else:
            out = tfb.finito_coeff_multistep_streamed(
                A, b, starts, invg[starts.long() // B], canch.clone(),
                zb.to(dev), z.clone(), av.clone(), sc, B, rs=rs)
    elif kind == "proshi":
        s = (((i[:, None] * 3 + j * 5) % 17 - 8).float() / 512).to(dev)
        gamma = ((i % 3 + 4).float() * 2.0**-14).to(dev)
        sc = torch.tensor([1.0, 1.0 / N, 2.0**-6, 0.0, -float("inf"),
                           2.0**-6, 1.0, 0.5], device=dev)
        out = tfb.proshi_multistep(A, b, gamma, s, starts, av.clone(),
                                   z.clone(), sc, B, rs=rs)
    elif kind in ("saga", "saga_stream"):
        sc = torch.tensor([1.0, 2.0**-12, 2.0**-18, 1.0 / B, 1.0 / N, 0.0,
                           0.0, 0.5], device=dev)
        fn = (tfb.saga_coeff_multistep if kind == "saga"
              else tfb.saga_coeff_multistep_streamed)
        out = fn(A, b, starts, canch.clone(), z.clone(), av.clone(), sc, B,
                 rs=rs)
    elif kind in ("point_saga", "point_saga_stream"):
        y = torch.where(b >= 0, 1.0, -1.0)
        Af = A.cpu().double()
        if rs is not None:
            Af = Af * rs.cpu().double()[:, None]
        na = (Af * Af).sum(1).float().to(dev)
        sc = torch.tensor([1.0, 2.0**-8, 1.0 / B, 1.0 / N, 1.0, 0.0],
                          device=dev)
        fn = (tfb.point_saga_multistep if kind == "point_saga"
              else tfb.point_saga_multistep_streamed)
        out = fn(A, y, na, canch.clone(), starts, z.clone(), av.clone(), sc,
                 B, mode=1, rs=rs)
    elif kind in ("ssnm", "ssnm_stream"):
        zb = ((torch.arange(N // B)[:, None] * 3 + j * 5) % 17 - 8).float()
        sc = torch.tensor([1.0, 2.0**-12, 2.0**-18, 1.0 / B, 1.0 / N, 0.0,
                           0.5, 0.5], device=dev)
        fn = (tfb.ssnm_multistep if kind == "ssnm"
              else tfb.ssnm_multistep_streamed)
        out = fn(A, b, starts, canch.clone(), (zb / 512).to(dev), z.clone(),
                 av.clone(), sc, B, rs=rs)
    elif kind == "lfinito":
        invg = (torch.arange(K) % 3 + 4).float() * 128
        sc = torch.tensor([1.0, 2.0**-12, 2.0**-18, 1.0 / N, 0.0, 0.5],
                          device=dev)
        out = tfb.lfinito_sweep_multistep(A, b, canch, starts, av.clone(), y,
                                          invg.to(dev), sc, B, rs=rs)
    else:
        sc = torch.tensor([1.0, 2.0**-12, 2.0**-18, 0.99, 0.01, 1.0 / 3.0,
                           0.5, 1.0 / B, 0.0, 0.5], device=dev)
        out = tfb.lkatyusha_coeff_multistep(A, b, canch, starts, None, z,
                                            y.clone(), z.clone(), av, sc, B,
                                            rs=rs)
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in out:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("kind", ["lsvrg", "lkatyusha", "katyusha",
                                  "sarah", "ssnm", "point_saga_stream"])
@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_loopless_kernels_repeat_bit_for_bit_at_width(dev, kind, storage,
                                                      monkeypatch):
    """Kernels #16, #17, #10, #11, #19 and #15 at the headline width (n =
    1,024, B = 4,096, K = 32: 128 CTAs, two grid barriers a step; #19 and
    #15 on blocks drawn with repeats, #15 on logistic rows) give the same
    bits in two calls, and on a 132-SM card their pinned bits
    (``LOOPLESS_GOLDEN``: #16's and #17's from the engine before #4 and #5
    joined it, one row group at this width, so neither the narrow-row
    split nor the methods added since changed their arithmetic; #19's
    equal #13's with no clamp count, #15's with no clamp count #12's); a
    grid other than the engine's rule is refused by the launch
    (RuntimeError) and counts no launch: nothing falls back to another
    kernel or to the plain version."""
    N, n, B, K = 32768, 1024, 4096, 32
    if kind == "point_saga_stream":
        F, L, na, state, starts = _ps_state(dev, N, n, B, K, "logistic",
                                            storage, seed=5)
        sc = _ps_scalars(F, 10.0 / (3.0 * L), N, B, dev)
        fn = tfb.point_saga_multistep_streamed

        def run():
            return _ps_run(fn, F, na, state, starts, sc, B)
    elif kind == "ssnm":
        F, L, state, starts = _ssnm_state(dev, N, n, B, K, storage, seed=5)
        sc = _ssnm_scalars(F, L, N, B, 0.5, 0.1, dev)
        fn = tfb.ssnm_multistep

        def run():
            return _run_state(fn, F, state, starts, sc, B)
    else:
        S = _vr_setup(dev, N, n, B, K, storage, seed=5)
        sc = _vr_scalars(S, kind, B, 0.1, dev)
        fn = getattr(tfb, VR_KERNELS[kind][0])

        def run():
            return _vr_run(kind, fn, S, sc, B)
    runs = [run() for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    if tfb._sm_count(dev.index) == 132:
        pinned = "point_saga" if kind == "point_saga_stream" else kind
        got = loopless_digest(dev, kind, storage)
        assert got == LOOPLESS_GOLDEN[pinned, storage], got
        if kind == "ssnm":
            assert loopless_digest(dev, "ssnm_stream", storage) == got
    rule = tfb._loopless_grid

    def halved(B_, n_, isz, sms, points=1):
        rows, ctas, S_, P = rule(B_, n_, isz, sms, points)
        return 2 * rows, -(-B_ // (2 * rows)), S_, P
    monkeypatch.setattr(tfb, "_loopless_grid", halved)
    before = fn.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        run()
    assert fn.launches == before


@pytest.mark.parametrize("kind", ["lsvrg", "lkatyusha", "point_saga_stream"])
@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_loopless_masked_steps_are_identity(dev, kind, storage):
    """Kernels #16 and #17 with stop read on the device: the steps past
    stop write nothing, so a call with stop = 9 equals the first 10 steps
    alone bit for bit (wpre/ypre included), stop = K - 1 equals stop None,
    stop = 0 is one step; the plain versions agree. #15 with its clamp
    count f (``_point_saga_masks``)."""
    N, B, K = 8192, 128, 32
    if kind == "point_saga_stream":
        _point_saga_masks(dev, N, B, K, storage)
        return
    S = _vr_setup(dev, N, 128, B, K, storage, seed=3)
    sc = _vr_scalars(S, kind, B, 0.1, dev)
    kname, rname = VR_KERNELS[kind]
    fn = getattr(tfb, kname)
    i32 = dict(dtype=torch.int32, device=dev)
    pairs = (
        (_vr_run(kind, fn, S, sc, B, stop=torch.tensor([9], **i32)),
         _vr_run(kind, fn, S, sc, B, starts=S["starts"][:10])),
        (_vr_run(kind, fn, S, sc, B, stop=torch.tensor(K - 1, **i32)),
         _vr_run(kind, fn, S, sc, B)),
        (_vr_run(kind, fn, S, sc, B, stop=torch.tensor([0], **i32)),
         _vr_run(kind, fn, S, sc, B, starts=S["starts"][:1])))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    plain = _vr_run(kind, getattr(tfb, rname), S, sc, B,
                    stop=torch.tensor([9], **i32))
    for k, r in zip(pairs[0][0], plain):
        assert _rel(k, r) <= 1e-5
    with pytest.raises(ValueError, match="one index"):
        _vr_run(kind, fn, S, sc, B, stop=torch.tensor([1, 2], **i32))
    with pytest.raises(TypeError, match="stop"):
        _vr_run(kind, fn, S, sc, B, stop=torch.tensor([1], device=dev))


def _point_saga_masks(dev, N, B, K, storage):
    """Kernel #15 on logistic rows with f read on the device: f = 10
    equals the first 10 steps alone bit for bit, f = K and f > K equal f
    None, f = 1 is one step (within the plain version's tolerances of
    ``test_point_saga_kernel_matches_plain_version``), f = 0 writes
    nothing. The shifted iterate v, the call's scratch: f = 0 leaves it
    as it was, f = 1 leaves step 0's v = x − γ·av, formed by every CTA,
    and f = 2 the v that step 0's finish formed from its x and av, no
    later one. A clamp count of two values or another dtype raises."""
    F, L, na, state, starts = _ps_state(dev, N, 128, B, K, "logistic",
                                        storage, seed=3)
    sc = _ps_scalars(F, 10.0 / (3.0 * L), N, B, dev)
    fn = tfb.point_saga_multistep_streamed
    i32 = dict(dtype=torch.int32, device=dev)

    def run(st=starts, **kw):
        return _ps_run(fn, F, na, state, st, sc, B, **kw)
    pairs = ((run(f=torch.tensor([10], **i32)), run(starts[:10])),
             (run(f=torch.tensor(K, **i32)), run()),
             (run(f=torch.tensor([K + 5], **i32)), run()),
             (run(f=torch.tensor([0], **i32)), list(state)))
    one = run(f=torch.tensor([1], **i32))
    plain = _ps_run(tfb.point_saga_multistep_streamed_ref, F, na, state,
                    starts, sc, B, f=torch.tensor([1], **i32))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    tol = 1e-5 if storage != "f32" else 1e-6
    assert float((plain[1] - state[1]).abs().max()) > 0
    for i, (k, r) in enumerate(zip(one, plain)):
        assert _rel(k, r) <= (tol if i == 1 else 10 * tol), (i, _rel(k, r))
    rows, offs = F.coeff_rows_data()
    gamma = sc[1]

    def scratch(f):
        c, x, av = [t.clone() for t in state]
        v = torch.full_like(x, float("nan"))
        fc = torch.tensor([f], **i32)
        tfb._loopless_launch(
            "point_saga_multistep_streamed", rows, offs,
            F.coeff_rows_scale(), dict(c=c, na=na), starts, B, "highest",
            sc, 6, (int(F.coeff_mode), fc.data_ptr()),
            dict(x=x, av=av, v=v))
        torch.cuda.synchronize()
        return v
    assert bool(torch.isnan(scratch(0)).all())
    assert torch.equal(scratch(1), state[1] - gamma * state[2])
    assert torch.equal(scratch(2), one[1] - gamma * one[2])
    with pytest.raises(ValueError, match="one count"):
        run(f=torch.tensor([1, 2], **i32))
    with pytest.raises(TypeError, match="f must"):
        run(f=torch.tensor([1], device=dev))


@pytest.mark.parametrize("kind", list(VR_KERNELS))
def test_vr_kernel_repeats_bit_for_bit_and_checks_arguments(dev, kind):
    S = _vr_setup(dev, 4096, 256, 256, 16, "int8", seed=1)
    sc = _vr_scalars(S, kind, 256, 0.1, dev)
    fn = getattr(tfb, VR_KERNELS[kind][0])
    runs = [_vr_run(kind, fn, S, sc, 256) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="scalars"):
        _vr_run(kind, fn, S, torch.zeros(3, device=dev), 256)
    with pytest.raises(TypeError, match="starts"):
        _vr_run(kind, fn, S, sc, 256, starts=S["starts"].long())
    with pytest.raises(ValueError, match="rs"):
        _vr_run(kind, fn, dict(S, rs=None), sc, 256)


ALTERNATION = r"""
import sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import torch
import test_torch_cuda as t
from ciao_tpu_torch.ops import fused_block as tfb

dev = torch.device("cuda", 0)
# (kind, N, n, B, K): #10 at the headline width (128 CTAs of 32 rows), #11
# at n = 16,384 (its one-stage ring), #16 on 64 CTAs of one row
cases = (("katyusha", 32768, 1024, 4096, 8), ("sarah", 8192, 16384, 1024, 8),
         ("lsvrg", 8192, 1024, 64, 32))
runs = []
for i, (kind, N, n, B, K) in enumerate(cases):
    S = t._vr_setup(dev, N, n, B, K, "f32", seed=40 + i)
    runs.append((kind, S, t._vr_scalars(S, kind, B, 0.1, dev), B))
plain = [t._vr_run(k, getattr(tfb, t.VR_KERNELS[k][1]), S, sc, B)
         for k, S, sc, B in runs]
first = None
for rep in range(4):
    outs = [t._vr_run(k, getattr(tfb, t.VR_KERNELS[k][0]), S, sc, B)
            for k, S, sc, B in runs]
    torch.cuda.synchronize()
    for (k, _, _, _), got, want in zip(runs, outs, plain):
        for i, (a, b) in enumerate(zip(got, want)):
            bound = 1e-5 if (k == "sarah" and i == 1) else 1e-6
            assert bool(torch.isfinite(a).all()), (k, i)
            assert t._rel(a, b) <= bound, (k, i, t._rel(a, b))
    if first is None:
        first = outs
    for got, again in zip(outs, first):
        assert all(torch.equal(a, b) for a, b in zip(got, again))
print("alternation: ok")
"""


def test_engine_kernels_in_turns_on_one_stream_match_plain_versions(dev):
    """Calls of #10, #11 and #16 in turns on one stream, four rounds with
    no host sync between the calls of a round: the three kernels share the
    stream's grid-barrier word, with grids of 128 CTAs (#10, #11) and 64
    (#16) and one or two stages a step, and each call still matches its
    plain version (1e-6 of the largest entry, SARAH's v 1e-5) and repeats
    the first round's bits. Run in a child process with a time limit, so
    that a barrier left in a wrong state fails the test and does not stall
    the suite."""
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", ALTERNATION,
                           os.path.dirname(here), here],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "alternation: ok" in proc.stdout


def test_vr_facades_send_every_gated_run_to_their_kernels(dev):
    """On the card the Katyusha, SARAH, L-SVRG and L-Katyusha facades
    with block sampling run every inner step on their kernels (Katyusha
    and SARAH: one launch per outer step of m ≤ 128 steps; the loopless
    pair: one launch per window of ≤ 32 steps, even for a 3-step run) and
    every anchor on kernel #6, with no fallback warning and no other
    kernel; the objectives fall. A closed gate (an IndBox prox) warns and
    runs stepwise."""
    import math
    import warnings

    from ciao_tpu_torch import LSVRG, SARAH, Katyusha, LKatyusha, runtime
    from ciao_tpu_torch.monitor import objective
    from ciao_tpu_torch.prox import IndBox, NormL1

    N, n, B = 4096, 64, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    A = torch.randn(N, n, generator=gen, device=dev)
    F = LeastSquaresRows(A, torch.randn(N, generator=gen, device=dev),
                         float(N))
    L = (A * A).sum(1) * N
    g = NormL1(torch.tensor(0.01, device=dev))
    x0 = torch.zeros(n, device=dev)
    names = [k for k, _ in VR_KERNELS.values()] + ["coeff_apply_all"]
    others = ("saga_coeff_multistep", "svrg_coeff_multistep",
              "finito_coeff_multistep")
    cases = ((Katyusha(maxit=4, m=64, batch=B, block_sampling=True),
              "katyusha_coeff_multistep", lambda it, d: d == it - 1),
             (SARAH(maxit=4, batch=B, block_sampling=True),
              "sarah_multistep", lambda it, d: d == it - 1),
             (LSVRG(maxit=201, batch=B, block_sampling=True),
              "lsvrg_coeff_multistep", lambda it, d: d >= 200 // 32),
             (LKatyusha(maxit=201, batch=B, block_sampling=True),
              "lkatyusha_coeff_multistep", lambda it, d: d >= 200 // 32),
             (LSVRG(maxit=4, batch=B, block_sampling=True),
              "lsvrg_coeff_multistep", lambda it, d: d >= 1))
    for solver, kname, ok in cases:
        before = {k: getattr(tfb, k).launches for k in names + list(others)}
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            x, it = solver(x0, F=F, g=g, L=L)
        d = {k: getattr(tfb, k).launches - before[k] for k in before}
        assert ok(it, d[kname]), (kname, d)
        assert all(d[k] == 0 for k in d if k not in (kname,
                                                     "coeff_apply_all"))
        if kname in ("katyusha_coeff_multistep", "sarah_multistep"):
            assert d["coeff_apply_all"] == it - 1
        assert float(objective(F, g, x)) < float(objective(F, g, x0)), kname
    runtime.reset_fallback_warnings()
    before = tfb.katyusha_coeff_multistep.launches
    with pytest.warns(UserWarning, match="Katyusha"):
        Katyusha(maxit=2, m=8, batch=B, block_sampling=True)(
            x0, F=F, g=IndBox(-math.inf, 1.0), L=L)
    assert tfb.katyusha_coeff_multistep.launches == before
    runtime.reset_fallback_warnings()


# ---------------------------------------------------------------------------
# kernels #4 and #5 on the persistent engine, and the engine's barrier word
# a stream
# ---------------------------------------------------------------------------

# (N, n, B, K) of kernel #4 at the engine's widths: the deep target's B =
# 8,192 at its n = 128 (64 rows a CTA, eight row groups of a warp) and the
# headline width n = 1,024 (one group)
ENGINE_SAGA = {"n128": (65536, 128, 8192, 32), "n1024": (32768, 1024, 4096,
                                                          32)}
ENGINE_STORAGES = [("f32", "highest"), ("f32", "default"), ("bf16", "highest"),
                   ("int8", "highest")]
ENGINE_STORAGE_IDS = ["f32", "f32-default", "bf16", "int8"]


def _revisits(N, B, K, gen, dev, aligned=True):
    """K block starts that revisit blocks inside one call: step 1 repeats
    step 0 (adjacent), step 4 step 2 and step 7 step 4 (within the ring's
    lookahead of up to eight stages), the rest drawn. Unaligned: any
    start in [0, N − B], steps 10-13 overlapping each other by part of a
    block."""
    if aligned:
        s = torch.randint(N // B, (K,), generator=gen, device=dev) * B
    else:
        s = torch.randint(N - B + 1, (K,), generator=gen, device=dev)
        s[10] = 37
        s[11] = 37 + B // 2 + 3
        s[12] = 37 + B // 3
        s[13] = 38
    s[1] = s[0]
    s[4] = s[2]
    s[7] = s[4]
    return s.to(torch.int32)


def _saga_steps(fn, F, state, starts, sc, B, precision, wgts, f=None):
    """One call of kernel #4 or #3 or their plain versions on copies of
    ``state`` (a clamp count ``f`` only where given)."""
    rows, offs = F.coeff_rows_data()
    st = [t.clone() for t in state]
    fn(rows, offs, starts, *st, sc, B, precision=precision,
       rs=F.coeff_rows_scale(), wgts=wgts, **({} if f is None else dict(f=f)))
    return st


def _check_engine_saga(F, state, starts, sc, B, precision, wgts, live,
                       got, pair=(tfb.saga_coeff_multistep_streamed,
                                  tfb.saga_coeff_multistep_streamed_ref)):
    """``got``, kernel #4's call (or #3's: ``pair``, the kernel and its
    plain version) with ``live`` steps processed, against
    the plain version: the whole call where the dots are exact f32 (z
    within 1e-6 of its largest entry, c and av 1e-5); where they round to
    bf16, step by step (each plain step taken once more by the kernel from
    the same state, within 1e-5 and 1e-4: one flipped bf16 rounding
    carries through every later step, so a K-step comparison holds no
    fixed bound), and the call equals its one-step calls bit for bit."""
    lowp = tfb._lowp(F.coeff_rows_data()[0], precision)
    tol = 1e-5 if lowp else 1e-6
    kern, plain = pair
    w = None if wgts is None else wgts[:live]
    if not lowp:
        want = _saga_steps(plain, F, state, starts[:live], sc, B, precision,
                           w)
        torch.cuda.synchronize()
        pairs = [(got, want)]
    else:
        ref, chain, pairs = list(state), list(state), []
        for k in range(live):
            s1, w1 = starts[k:k + 1], None if w is None else w[k:k + 1]
            pairs.append((_saga_steps(kern, F, ref, s1, sc, B, precision, w1),
                          _saga_steps(plain, F, ref, s1, sc, B, precision,
                                      w1)))
            chain = _saga_steps(kern, F, chain, s1, sc, B, precision, w1)
            ref = pairs[-1][1]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, chain))
    for (kc, kz, kav), (rc, rz, rav) in pairs:
        assert bool(torch.isfinite(kz).all())
        assert _rel(kz, rz) <= tol
        assert _rel(kav, rav) <= 10 * tol
        assert _rel(kc, rc) <= 10 * tol
    assert float((pairs[-1][1][1] - state[1]).abs().max()) > 0


@pytest.mark.parametrize("f", [None, 0, 16], ids=["f=None", "f=0", "f=K/2"])
@pytest.mark.parametrize("weighted", [False, True], ids=["uniform", "wgts"])
@pytest.mark.parametrize("sag", [False, True], ids=["saga", "sag"])
@pytest.mark.parametrize("storage,precision", ENGINE_STORAGES,
                         ids=ENGINE_STORAGE_IDS)
@pytest.mark.parametrize("shape", list(ENGINE_SAGA))
def test_streamed_kernel_on_the_engine_matches_plain_version(
        dev, shape, storage, precision, sag, weighted, f):
    """Kernel #4, one cooperative launch a call, at the deep target's
    width (n = 128, B = 8,192) and at n = 1,024, on a schedule that
    revisits blocks inside the call (adjacent and within the ring's
    lookahead, where a prefetched coefficient would be stale), with and
    without weights, SAGA and SAG, the clamp count f read on the device:
    f = 0 leaves the state bit for bit as it was, f = K/2 is the first
    K/2 steps; against the plain version (``_check_engine_saga``)."""
    N, n, B, K = ENGINE_SAGA[shape]
    F, state, _, sc, wgts = _setup(dev, N, n, B, K, storage, sag, weighted,
                                   seed=21)
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    starts = _revisits(N, B, K, gen, dev)
    fc = None if f is None else torch.tensor([f], dtype=torch.int32,
                                             device=dev)
    before = tfb.saga_coeff_multistep_streamed.launches
    got = _saga_steps(tfb.saga_coeff_multistep_streamed, F, state, starts,
                      sc, B, precision, wgts, fc)
    torch.cuda.synchronize()
    assert tfb.saga_coeff_multistep_streamed.launches == before + 1
    if f == 0:
        assert all(torch.equal(a, b) for a, b in zip(got, state))
        return
    _check_engine_saga(F, state, starts, sc, B, precision, wgts,
                       K if f is None else f, got)


@pytest.mark.parametrize("storage,precision", ENGINE_STORAGES,
                         ids=ENGINE_STORAGE_IDS)
@pytest.mark.parametrize("shape", list(ENGINE_SAGA))
def test_streamed_kernel_takes_unaligned_overlapping_starts(dev, shape,
                                                            storage,
                                                            precision):
    """Kernel #4 on starts that are not multiples of B (the wrapper takes
    any start in [0, N − B]) and overlap each other inside the call, so
    one CTA reads coefficients that another wrote a step before: against
    the plain version as above, with weights."""
    N, n, B, K = ENGINE_SAGA[shape]
    F, state, _, sc, wgts = _setup(dev, N, n, B, K, storage, False, True,
                                   seed=23)
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    starts = _revisits(N, B, K, gen, dev, aligned=False)
    assert bool((starts % B != 0).any())
    got = _saga_steps(tfb.saga_coeff_multistep_streamed, F, state, starts,
                      sc, B, precision, wgts)
    torch.cuda.synchronize()
    _check_engine_saga(F, state, starts, sc, B, precision, wgts, K, got)


# (N, n, B, K) of #3 and #12 at the engine's edges: the headline width at B
# = 4,096 and 1,024 (32 and 8 rows a CTA: four f32 stages a step, and one),
# one f32 row a stage (n = 16,384, the wide build, where Point-SAGA solves a
# stage's rows at a time) and a width that is not whole 16-byte chunks (the
# plain path)
ENGINE_EDGES = {"n1024": (32768, 1024, 4096, 32),
                "n1024-B1024": (32768, 1024, 1024, 32),
                "n16384": (8192, 16384, 1024, 8),
                "n202": (8192, 202, 1024, 32)}


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("shape", list(ENGINE_EDGES))
def test_saga_kernel_on_the_engine_takes_revisits_and_matches_plain_version(
        dev, shape, storage):
    """Kernel #3, one cooperative launch a call, at the engine's edges
    (``ENGINE_EDGES``), weighted, on a schedule that revisits blocks inside
    the call (the table is written and read back inside the launch),
    against the plain version (``_check_engine_saga``)."""
    N, n, B, K = ENGINE_EDGES[shape]
    F, state, _, sc, wgts = _setup(dev, N, n, B, K, storage, False, True,
                                   seed=51)
    gen = torch.Generator(device=dev)
    gen.manual_seed(52)
    starts = _revisits(N, B, K, gen, dev)
    before = tfb.saga_coeff_multistep.launches
    got = _saga_steps(tfb.saga_coeff_multistep, F, state, starts, sc, B,
                      "highest", wgts)
    torch.cuda.synchronize()
    assert tfb.saga_coeff_multistep.launches == before + 1
    _check_engine_saga(F, state, starts, sc, B, "highest", wgts, K, got,
                       pair=(tfb.saga_coeff_multistep,
                             tfb.saga_coeff_multistep_ref))


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("kind", ["lsq", "logistic", "poisson"])
@pytest.mark.parametrize("shape", list(ENGINE_EDGES))
def test_point_saga_on_the_engine_takes_revisits_and_matches_plain_version(
        dev, shape, kind, storage):
    """Kernel #12, one cooperative launch a call, at the engine's edges
    (``ENGINE_EDGES``: the logistic and Poisson rows of a step of several
    stages solved together after all its margins, at n = 1,024 and B =
    4,096 with f32 and bf16 rows; one stage at a time elsewhere, and for
    least squares everywhere), on a schedule that
    revisits blocks inside the call, at 10x the default γ, step by step
    against the plain version (x within 1e-6 of its largest entry, 1e-5
    where the dots round to bf16, c and av within 10x that, as
    ``test_point_saga_kernel_matches_plain_version``); the K-step call
    equals its one-step calls bit for bit."""
    N, n, B, K = ENGINE_EDGES[shape]
    F, L, na, state, _ = _ps_state(dev, N, n, B, K, kind, storage, seed=53)
    gen = torch.Generator(device=dev)
    gen.manual_seed(54)
    starts = _revisits(N, B, K, gen, dev)
    sc = _ps_scalars(F, 10.0 / (3.0 * L), N, B, dev)
    fn = tfb.point_saga_multistep
    tol = 1e-5 if tfb._lowp(F.coeff_rows_data()[0], "highest") else 1e-6
    before = fn.launches
    whole = _ps_run(fn, F, na, state, starts, sc, B)
    ref = [t.clone() for t in state]
    chain = [t.clone() for t in state]
    for k in range(K):
        s1 = starts[k:k + 1]
        got = _ps_run(fn, F, na, ref, s1, sc, B)
        _ps_run(fn, F, na, chain, s1, sc, B, inplace=True)
        _ps_run(tfb.point_saga_multistep_ref, F, na, ref, s1, sc, B,
                inplace=True)
        torch.cuda.synchronize()
        for i, (g_, r) in enumerate(zip(got, ref)):
            assert bool(torch.isfinite(g_).all())
            assert _rel(g_, r) <= (tol if i == 1 else 10 * tol), (
                k, i, _rel(g_, r))
    assert fn.launches == before + 1 + 2 * K
    assert all(torch.equal(a, b) for a, b in zip(whole, chain))
    assert float((ref[1] - state[1]).abs().max()) > 0


# (N, n, B) of kernel #5 at the headline width, and its calls' K: a driver
# call of LAUNCH_STEPS = 128 steps and a short remainder call
ENGINE_SVRG = (32768, 1024, 4096)


@pytest.mark.parametrize("K", [128, 5], ids=["K=128", "K=5"])
@pytest.mark.parametrize("storage,precision", ENGINE_STORAGES,
                         ids=ENGINE_STORAGE_IDS)
def test_svrg_kernel_on_the_engine_matches_plain_version(dev, storage,
                                                         precision, K):
    """Kernel #5, one cooperative launch a call, at n = 1,024, B = 4,096
    against its plain version: w and zs within 1e-6 of their largest
    entry over the whole call where the dots are exact f32; where they
    round to bf16, within 1e-5 step by step (each plain step taken once
    more by the kernel from the same state), the call equal to its
    one-step calls bit for bit."""
    N, n, B = ENGINE_SVRG
    F, canch, state, av, starts, sc = _svrg_setup(dev, N, n, B, K, storage,
                                                   0.1, seed=25)
    rows, offs = F.coeff_rows_data()
    rs = F.coeff_rows_scale()

    def run(fn, st, s):
        out = [t.clone() for t in st]
        fn(rows, offs, s, canch, *out, av, sc, B, precision=precision,
           rs=rs)
        return out

    before = tfb.svrg_coeff_multistep.launches
    got = run(tfb.svrg_coeff_multistep, state, starts)
    torch.cuda.synchronize()
    assert tfb.svrg_coeff_multistep.launches == before + 1
    lowp = tfb._lowp(rows, precision)
    if not lowp:
        pairs = [(got, run(tfb.svrg_coeff_multistep_ref, state, starts))]
    else:
        ref, chain, pairs = list(state), list(state), []
        for k in range(K):
            s = starts[k:k + 1]
            pairs.append((run(tfb.svrg_coeff_multistep, ref, s),
                          run(tfb.svrg_coeff_multistep_ref, ref, s)))
            chain = run(tfb.svrg_coeff_multistep, chain, s)
            ref = pairs[-1][1]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, chain))
    torch.cuda.synchronize()
    tol = 1e-5 if lowp else 1e-6
    for (kw, kzs), (rw, rzs) in pairs:
        assert bool(torch.isfinite(kw).all())
        assert _rel(kw, rw) <= tol
        assert _rel(kzs, rzs) <= tol
    assert float((pairs[-1][1][0] - state[0]).abs().max()) > 0


@pytest.mark.parametrize("kernel", ["#4 n128", "#4 n1024", "#5", "#3",
                                    "#12"])
@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_engine_kernels_repeat_bit_for_bit_at_width(dev, kernel, storage,
                                                    monkeypatch):
    """Kernels #4 (at the deep target's width and at n = 1,024, weighted,
    with revisits), #5 (at the headline width, K = 128), #3 (n = 1,024,
    weighted, with revisits) and #12 (n = 1,024, logistic rows, with
    revisits) give the same bits in two calls; #3's and #12's are their
    pinned bits on a 132-SM card (``LOOPLESS_GOLDEN``), where #3's also
    equal #4's with no clamp count; a grid other than the engine's rule is
    refused by the launch (RuntimeError) and counts no launch: nothing
    falls back to the two-launch engine or to the plain version."""
    if kernel == "#12":
        N, n, B, K = ENGINE_SAGA["n1024"]
        F, L, na, state, _ = _ps_state(dev, N, n, B, K, "logistic", storage,
                                       seed=27)
        gen = torch.Generator(device=dev)
        gen.manual_seed(28)
        starts = _revisits(N, B, K, gen, dev)
        sc = _ps_scalars(F, 10.0 / (3.0 * L), N, B, dev)
        fn = tfb.point_saga_multistep

        def run():
            return _ps_run(fn, F, na, state, starts, sc, B)
    elif kernel == "#5":
        N, n, B = ENGINE_SVRG
        F, canch, state, av, starts, sc = _svrg_setup(dev, N, n, B, 128,
                                                       storage, 0.1, seed=26)
        rows, offs = F.coeff_rows_data()
        fn = tfb.svrg_coeff_multistep

        def run():
            st = [t.clone() for t in state]
            fn(rows, offs, starts, canch, *st, av, sc, B,
               rs=F.coeff_rows_scale())
            return st
    else:
        shape = "n1024" if kernel == "#3" else kernel.split()[1]
        N, n, B, K = ENGINE_SAGA[shape]
        F, state, _, sc, wgts = _setup(dev, N, n, B, K, storage, False, True,
                                       seed=27)
        gen = torch.Generator(device=dev)
        gen.manual_seed(28)
        starts = _revisits(N, B, K, gen, dev)
        fn = (tfb.saga_coeff_multistep if kernel == "#3"
              else tfb.saga_coeff_multistep_streamed)

        def run():
            return _saga_steps(fn, F, state, starts, sc, B, "highest", wgts)
    runs = [run() for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert not torch.equal(runs[0][-1], state[-1])
    if kernel in ("#3", "#12") and tfb._sm_count(dev.index) == 132:
        kind = "saga" if kernel == "#3" else "point_saga"
        got = loopless_digest(dev, kind, storage)
        assert got == LOOPLESS_GOLDEN[kind, storage], got
        if kernel == "#3":
            assert loopless_digest(dev, "saga_stream", storage) == got
    rule = tfb._loopless_grid

    def halved(B_, n_, isz, sms, points=1):
        rows_, ctas, S_, P = rule(B_, n_, isz, sms, points)
        return 2 * rows_, -(-B_ // (2 * rows_)), S_, P
    monkeypatch.setattr(tfb, "_loopless_grid", halved)
    before = fn.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        run()
    assert fn.launches == before


# ---------------------------------------------------------------------------
# kernels #9 and #8 on the persistent engine
# ---------------------------------------------------------------------------

# (N, n, B, K, storage, precision) of kernels #9 and #8 at the engine's
# edges: the deep target's width (n = 128, B = 8,192: 64 rows a CTA, eight
# row groups of a warp), the headline width at B = 4,096 and 1,024 (one
# group; 32 and 8 rows a CTA, four and one f32 stages a step), one f32 row a
# stage (n = 16,384: two stages, the wide build), widths that are not whole
# 16-byte chunks (the plain path), and a B that the rows a CTA do not divide
# (4,100 = 128 x 32 + 4 on 132 SMs: the last CTA takes four rows)
FINITO_EDGES = {
    "n128": (65536, 128, 8192, 32, "f32", "highest"),
    "n128-default": (65536, 128, 8192, 32, "f32", "default"),
    "n128-int8": (65536, 128, 8192, 32, "int8", "highest"),
    "n1024": (32768, 1024, 4096, 32, "f32", "highest"),
    "n1024-bf16": (32768, 1024, 4096, 32, "bf16", "highest"),
    "n1024-int8": (32768, 1024, 4096, 32, "int8", "highest"),
    "n1024-B1024": (32768, 1024, 1024, 32, "f32", "highest"),
    "n16384": (8192, 16384, 1024, 8, "f32", "highest"),
    "n202": (8192, 202, 1024, 32, "f32", "highest"),
    "n200-int8": (8192, 200, 1024, 32, "int8", "highest"),
    "B4100": (32800, 1024, 4100, 16, "f32", "highest"),
}
FINITO_FNS = {"finito": ("finito_coeff_multistep",
                         "finito_coeff_multistep_ref"),
              "lfinito": ("lfinito_sweep_multistep",
                          "lfinito_sweep_multistep_ref"),
              "finito_stream": ("finito_coeff_multistep_streamed",
                                "finito_coeff_multistep_streamed_ref")}
# each kernel's outputs, and the indices of its point z and average av
FINITO_OUTS = {"finito": (("c", "zb", "z", "av"), 2, 3),
               "lfinito": (("av", "z"), 1, 0),
               "finito_stream": (("c", "zb", "z", "av"), 2, 3)}


def _engine_finito_setup(dev, kind, N, n, B, K, storage, lam=0.1, seed=31):
    """Kernel #9's or #14's state (``_finito_setup``) or #8's epoch start
    (the anchor z_full = z, its coefficients, av = z_full − hat·Σ c_i
    a_i/N), on a schedule that revisits blocks inside the call
    (``_revisits``)."""
    F, (c, zb, z, av), _, invg, _, sc9 = _finito_setup(dev, N, n, B, K,
                                                       storage, lam, seed=seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    rows, offs = F.coeff_rows_data()
    S = dict(kind=kind, rows=rows, offs=offs, rs=F.coeff_rows_scale(), B=B,
             invg=invg, starts=_revisits(N, B, K, gen, dev), lam=lam)
    if kind != "lfinito":
        S.update(sc=sc9, state=(c, zb, z, av))
    else:
        hat = float(sc9[2])
        canch = F.coeff_all(z)
        S.update(sc=torch.tensor([N, hat, hat * lam, 1.0 / N, 0.0, 0.0],
                                 device=dev),
                 canch=canch, zf=z, hat=hat,
                 state=(z - hat / N * F.apply_all(canch),))
    return S


def _engine_finito_call(fn, S, state, starts=None, precision="highest",
                        f=None):
    """One call of kernel #9, #14 (clamp count ``f``) or #8, or its plain
    version, on ``state`` (#9's and #14's [c, zb, z, av], #8's [av]) in
    place; returns the outputs (#9's and #14's c, zb, z, av; #8's av,
    z)."""
    starts = S["starts"] if starts is None else starts
    kw = dict(precision=precision, rs=S["rs"])
    if S["kind"] == "finito":
        c, zb, z, av = state
        fn(S["rows"], S["offs"], starts, c, zb, S["invg"], z, av, S["sc"],
           S["B"], **kw)
        return list(state)
    if S["kind"] == "finito_stream":
        fn(S["rows"], S["offs"], starts,
           S["invg"][starts.long() // S["B"]].contiguous(), *state, S["sc"],
           S["B"], f=f, **kw)
        return list(state)
    iv = S["invg"][starts.long() // S["B"]].contiguous()
    return list(fn(S["rows"], S["offs"], S["canch"], starts, state[0],
                   S["zf"], iv, S["sc"], S["B"], **kw))


def _fresh(state):
    return [t.clone() for t in state]


def _check_engine_finito(S, precision, got):
    """``got``, one call of kernel #9, #14 or #8 from S's state, against the
    plain version, as ``_check_engine_saga`` holds #4: the whole call where
    the dots are exact f32 (z within 1e-6 of its largest entry, c, zb and
    av within 1e-5); where they round to bf16, step by step (each plain
    step taken once more by the kernel from the same state, within 1e-5
    and 1e-4), and the call equals its one-step calls bit for bit."""
    kern, plain = (getattr(tfb, f) for f in FINITO_FNS[S["kind"]])
    names, zi, ai = FINITO_OUTS[S["kind"]]
    lowp = tfb._lowp(S["rows"], precision)
    tol = 1e-5 if lowp else 1e-6
    if not lowp:
        pairs = [(got, _engine_finito_call(plain, S, _fresh(S["state"]),
                                           precision=precision))]
    else:
        ref, chain, pairs = _fresh(S["state"]), _fresh(S["state"]), []
        for k in range(S["starts"].shape[0]):
            s1 = S["starts"][k:k + 1]
            one = _engine_finito_call(kern, S, _fresh(ref), s1, precision)
            want = _engine_finito_call(plain, S, ref, s1, precision)
            pairs.append((one, _fresh(want)))
            last = _engine_finito_call(kern, S, chain, s1, precision)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, last))
    torch.cuda.synchronize()
    for kout, rout in pairs:
        for i, (k, r) in enumerate(zip(kout, rout)):
            assert bool(torch.isfinite(k).all()), names[i]
            bound = tol if i == zi else 10 * tol
            assert _rel(k, r) <= bound, (names[i], _rel(k, r))
    assert float((pairs[-1][1][ai] - S["state"][-1]).abs().max()) > 0


@pytest.mark.parametrize("kind", list(FINITO_FNS))
@pytest.mark.parametrize("shape", list(FINITO_EDGES))
def test_finito_kernels_on_the_engine_take_revisits_and_match_plain_versions(
        dev, shape, kind):
    """Kernels #9, #14 and #8, one cooperative launch a call, at the
    engine's edges (``FINITO_EDGES``), on a schedule that revisits blocks
    inside the call, adjacently and within the ring's lookahead (#9's and
    #14's table c, anchors zb and point z are written and read back inside
    the launch, where the read-only path could return a stale line),
    against the plain versions in every output (``_check_engine_finito``);
    #8's z is the last block's prox point, not soft of the returned av."""
    N, n, B, K, storage, precision = FINITO_EDGES[shape]
    S = _engine_finito_setup(dev, kind, N, n, B, K, storage)
    fn = getattr(tfb, FINITO_FNS[kind][0])
    before = fn.launches
    got = _engine_finito_call(fn, S, _fresh(S["state"]), precision=precision)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _check_engine_finito(S, precision, got)
    if kind == "lfinito":
        av, z = got
        thr = S["hat"] * S["lam"]
        assert not torch.equal(
            z, torch.sign(av) * torch.clamp(av.abs() - thr, min=0))


# (N, n, B, K) of #9 and #8 at the headline width and the deep target's
FINITO_WIDTHS = {"n1024": (32768, 1024, 4096, 32),
                 "n128": (65536, 128, 8192, 32)}


@pytest.mark.parametrize("kind", list(FINITO_FNS))
@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("width", list(FINITO_WIDTHS))
def test_finito_kernels_repeat_bit_for_bit_at_width(dev, width, storage,
                                                    kind, monkeypatch):
    """Kernels #9, #14 and #8 at the headline width (n = 1,024, B =
    4,096) and the deep target's (n = 128, B = 8,192), K = 32 with
    revisits, give the same bits in two calls, and on a 132-SM card their
    pinned bits at n = 1,024 (``LOOPLESS_GOLDEN``); a grid other than the
    engine's rule is refused by the launch (RuntimeError) and counts no
    launch: nothing falls back."""
    N, n, B, K = FINITO_WIDTHS[width]
    S = _engine_finito_setup(dev, kind, N, n, B, K, storage, seed=33)
    fn = getattr(tfb, FINITO_FNS[kind][0])
    runs = [_engine_finito_call(fn, S, _fresh(S["state"])) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert not torch.equal(runs[0][FINITO_OUTS[kind][2]], S["state"][-1])
    if width == "n1024" and tfb._sm_count(dev.index) == 132:
        assert loopless_digest(dev, kind, storage) == LOOPLESS_GOLDEN[
            kind, storage]
    rule = tfb._loopless_grid

    def halved(B_, n_, isz, sms, points=1):
        rows_, ctas, S_, P = rule(B_, n_, isz, sms, points)
        return 2 * rows_, -(-B_ // (2 * rows_)), S_, P
    monkeypatch.setattr(tfb, "_loopless_grid", halved)
    before = fn.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        _engine_finito_call(fn, S, _fresh(S["state"]))
    assert fn.launches == before


# ---------------------------------------------------------------------------
# kernels #14 and #18 on the persistent engine
# ---------------------------------------------------------------------------

# (N, n, B, K, storage) of kernel #18 at the engine's edges: the narrow-row
# split (n = 128, B = 8,192: 64 rows a CTA), the headline width at B = 4,096
# and 1,024 (a round of eight rows a stage f32; four of them a 32-row int8
# stage), two rows a round (n = 4,096, four units a thread), one f32 row a
# stage (n = 16,384, sixteen units: one row a round, no load ahead), widths
# that are not whole 16-byte chunks (the plain path, four and 64 units a
# thread), and a B that the rows a CTA do not divide
PROSHI_EDGES = {
    "n128": (65536, 128, 8192, 32, "f32"),
    "n1024": (32768, 1024, 4096, 32, "f32"),
    "n1024-bf16": (32768, 1024, 4096, 32, "bf16"),
    "n1024-int8": (32768, 1024, 4096, 32, "int8"),
    "n1024-B1024": (32768, 1024, 1024, 32, "f32"),
    "n4096-int8": (16384, 4096, 2048, 16, "int8"),
    "n16384": (8192, 16384, 1024, 8, "f32"),
    "n202": (8192, 202, 1024, 32, "f32"),
    "n200-int8": (8192, 200, 1024, 32, "int8"),
    "n1030": (8192, 1030, 1024, 16, "f32"),
    "B4100": (32800, 1024, 4100, 16, "f32"),
}


def _engine_proshi_setup(dev, N, n, B, K, storage, gname, seed=41):
    """A ProShI state (``_proshi_setup``) on a schedule that revisits
    blocks inside the call (``_revisits``)."""
    F, st, _, sc = _proshi_setup(dev, N, n, B, K, storage, gname, seed=seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    return F, st, _revisits(N, B, K, gen, dev), sc


@pytest.mark.parametrize("gname", ["box", "l1", "zero"])
@pytest.mark.parametrize("shape", list(PROSHI_EDGES))
def test_proshi_on_the_engine_takes_revisits_and_matches_plain_version(
        dev, shape, gname):
    """Kernel #18, one cooperative launch a call, at the engine's edges
    (``PROSHI_EDGES``), on a schedule that revisits blocks inside the
    call, adjacently and within the ring's lookahead (the table rows, av
    and z are written and read back inside the launch): s and av within
    1e-6 of their largest entries (the margins are exact f32 with any
    rows), "default" precision the same bits; z ≡ 0 with g = Zero. z =
    (prox_g(av) − av)/hat is a difference of av-sized values, the prox
    1-Lipschitz, so it is held to 1e-6 of max |av| / hat, the bound the
    av check gives it: its largest entry can be far below that (IndBox
    clips at 1 an av of tens at N ≥ 8,192), and both versions' f32 av,
    1e-8 apart relative to max |av| there, then differ by more than 1e-6
    of max |z|."""
    N, n, B, K, storage = PROSHI_EDGES[shape]
    F, st, starts, sc = _engine_proshi_setup(dev, N, n, B, K, storage, gname)
    before = tfb.proshi_multistep.launches
    kern = _proshi_run(tfb.proshi_multistep, F, st, starts, sc, B)
    low = _proshi_run(tfb.proshi_multistep, F, st, starts, sc, B, "default")
    ref = _proshi_run(tfb.proshi_multistep_ref, F, st, starts, sc, B)
    torch.cuda.synchronize()
    assert tfb.proshi_multistep.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(kern, low))
    assert float((ref[0] - st.s).abs().max()) > 0
    for name, k, r in zip(("s", "av"), kern, ref):
        assert bool(torch.isfinite(k).all()), name
        assert _rel(k, r) <= 1e-6, (name, _rel(k, r))
    assert bool(torch.isfinite(kern[2]).all())
    dz = float((kern[2] - ref[2]).abs().max())
    assert dz <= 1e-6 * float(ref[1].abs().max()) / float(st.hat_gamma), dz
    if gname == "zero":
        assert not bool(kern[2].any())


# (N, n, B, K) of #18 at the headline width and the deep target's
PROSHI_WIDTHS = {"n1024": (32768, 1024, 4096, 32),
                 "n128": (65536, 128, 8192, 32)}


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("width", list(PROSHI_WIDTHS))
def test_proshi_repeats_bit_for_bit_at_width(dev, width, storage,
                                             monkeypatch):
    """Kernel #18 at the headline width (n = 1,024, B = 4,096) and the
    deep target's (n = 128, B = 8,192), K = 32 with revisits, gives the
    same bits in two calls, and on a 132-SM card its pinned bits at n =
    1,024 (``LOOPLESS_GOLDEN``); a grid other than the engine's rule is
    refused by the launch (RuntimeError) and counts no launch: nothing
    falls back to the two-launch walk or to the plain version."""
    N, n, B, K = PROSHI_WIDTHS[width]
    F, st, starts, sc = _engine_proshi_setup(dev, N, n, B, K, storage, "box",
                                             seed=43)
    fn = tfb.proshi_multistep
    runs = [_proshi_run(fn, F, st, starts, sc, B) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert not torch.equal(runs[0][0], st.s)
    if width == "n1024" and tfb._sm_count(dev.index) == 132:
        assert loopless_digest(dev, "proshi", storage) == LOOPLESS_GOLDEN[
            "proshi", storage]
    rule = tfb._loopless_grid

    def halved(B_, n_, isz, sms, points=1):
        rows_, ctas, S_, P = rule(B_, n_, isz, sms, points)
        return 2 * rows_, -(-B_ // (2 * rows_)), S_, P
    monkeypatch.setattr(tfb, "_loopless_grid", halved)
    before = fn.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        _proshi_run(fn, F, st, starts, sc, B)
    assert fn.launches == before


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("width", list(PROSHI_WIDTHS))
@pytest.mark.parametrize("kind", ["proshi", "finito_stream"])
def test_engine_clamp_count_masks_steps_bit_for_bit(dev, kind, width,
                                                    storage):
    """Kernels #18 and #14 with the clamp count read on the device, at the
    headline width and the deep target's, on a schedule with revisits: f
    = 9 of K = 32 gives the first 9 steps alone bit for bit, f = K the
    call without a count, and f = 0 leaves every input as it was."""
    N, n, B, K = PROSHI_WIDTHS[width]
    i32 = dict(dtype=torch.int32, device=dev)
    if kind == "proshi":
        F, st, starts, sc = _engine_proshi_setup(dev, N, n, B, K, storage,
                                                 "l1", seed=45)
        state = (st.s, st.av, st.z)

        def run(starts_=starts, f=None):
            return _proshi_run(tfb.proshi_multistep, F, st, starts_, sc, B,
                               f=f)
    else:
        S = _engine_finito_setup(dev, kind, N, n, B, K, storage, seed=45)
        state = S["state"]

        def run(starts_=S["starts"], f=None):
            return _engine_finito_call(tfb.finito_coeff_multistep_streamed,
                                       S, _fresh(state), starts_, f=f)
    starts_all = starts if kind == "proshi" else S["starts"]
    pairs = ((run(f=torch.tensor([9], **i32)), run(starts_all[:9])),
             (run(f=torch.tensor([K], **i32)), run()),
             (run(f=torch.tensor([0], **i32)), list(state)))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(pairs[0][0][0], state[0])


TWO_STREAMS = r"""
import sys
import torch
sys.path.insert(0, sys.argv[1])
from ciao_tpu_torch.ops import fused_block as tfb
from ciao_tpu_torch.oracles import LeastSquaresRows

B, kind, reps = int(sys.argv[2]), sys.argv[3], 20
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev)
gen.manual_seed(29)
N, n, K = 16 * B, 1024, 32
A = torch.randn(N, n, generator=gen, device=dev)
F = LeastSquaresRows(A, torch.randn(N, generator=gen, device=dev), float(N))
rows, offs = F.coeff_rows_data()
xa = 0.05 * torch.randn(n, generator=gen, device=dev)
canch = F.coeff_all(xa)
av = F.apply_all(canch) / N
g = 1.0 / (6.0 * float((A * A).sum(1).max()) * N)
sc = torch.tensor([N, g, g * 0.1, 1.0 / B, 0.0, 0.0], device=dev)
starts = [(torch.randint(16, (K,), generator=gen, device=dev) * B).to(
    torch.int32) for _ in range(2)]
w0 = [xa + 0.01 * torch.randn(n, generator=gen, device=dev)
      for _ in range(2)]
# Finito's: per-block anchors near xa, their sums of 1/gamma (hat·invg_j =
# 1/16), scalars [scale, 1/N, hat, hat·lambda, mode, aux] (#9) and
# [scale, hat, hat·lambda, 1/N, mode, aux] (#8)
hat = 1.0 / (float((A * A).sum(1).mean()) * N)
zb0 = xa + 0.01 * torch.randn(16, n, generator=gen, device=dev)
invg = torch.full((16,), 1.0 / (16 * hat), device=dev)
sc9 = torch.tensor([N, 1.0 / N, hat, hat * 0.1, 0.0, 0.0], device=dev)
sc8 = torch.tensor([N, hat, hat * 0.1, 1.0 / N, 0.0, 0.0], device=dev)
# ProShI's: gamma_i = 0.999/|a_i|^2, a table s near 0, av = sum s,
# IndBox(-inf, 1): scalars [scale, 1/N, 1/hat, mode, glo, ghi, gmode, aux]
gam = 0.999 / (A * A).sum(1)
s0 = 0.05 * torch.randn(N, n, generator=gen, device=dev)
av18 = s0.sum(0)
ghat = float(gam.sum())
z18 = (torch.clamp(av18, max=1.0) - av18) / ghat
sc18 = torch.tensor([N, 1.0 / N, 1.0 / ghat, 0.0, -float("inf"), 1.0, 1.0,
                     0.0], device=dev)
# SAGA's [scale, gamma, gamma·lambda, 1/B, 1/N, sag, mode, aux] (#3);
# Point-SAGA's least-squares [scale, gamma, 1/B, 1/N, mode, aux] and the
# rows' square-norms (#12, #15)
sc3 = torch.tensor([N, g, g * 0.1, 1.0 / B, 1.0 / N, 0.0, 0.0, 0.0],
                   device=dev)
sc12 = torch.tensor([N, g, 1.0 / B, 1.0 / N, 0.0, 0.0], device=dev)
na = (A * A).sum(1)
# SSNM's [scale, eta, eta·lambda, 1/B, 1/N, mode, tau, aux] (#19, #13), its
# stored points Finito's anchors
sc19 = torch.tensor([N, g, g * 0.1, 1.0 / B, 1.0 / N, 0.0, 0.5, 0.0],
                    device=dev)


def call(i):
    if kind == "saga":
        c, z, a = canch.clone(), w0[i].clone(), av.clone()
        tfb.saga_coeff_multistep(rows, offs, starts[i], c, z, a, sc3, B)
        return c, z, a
    if kind in ("point_saga", "point_saga_stream"):
        c, x, a = canch.clone(), w0[i].clone(), av.clone()
        fn = (tfb.point_saga_multistep if kind == "point_saga"
              else tfb.point_saga_multistep_streamed)
        fn(rows, offs, na, c, starts[i], x, a, sc12, B)
        return c, x, a
    if kind == "finito":
        c, zb, z, a = canch.clone(), zb0.clone(), w0[i].clone(), av.clone()
        tfb.finito_coeff_multistep(rows, offs, starts[i], c, zb, invg, z, a,
                                   sc9, B)
        return c, zb, z, a
    if kind in ("ssnm", "ssnm_stream"):
        c, zb, x, a = canch.clone(), zb0.clone(), w0[i].clone(), av.clone()
        fn = (tfb.ssnm_multistep if kind == "ssnm"
              else tfb.ssnm_multistep_streamed)
        fn(rows, offs, starts[i], c, zb, x, a, sc19, B)
        return c, zb, x, a
    if kind == "finito_stream":
        c, zb, z, a = canch.clone(), zb0.clone(), w0[i].clone(), av.clone()
        tfb.finito_coeff_multistep_streamed(
            rows, offs, starts[i], invg[starts[i].long() // B], c, zb, z, a,
            sc9, B)
        return c, zb, z, a
    if kind == "proshi":
        s_, a, z = s0.clone(), av18.clone(), z18.clone()
        tfb.proshi_multistep(rows, offs, gam, s_, starts[i], a, z, sc18, B)
        return s_, a, z
    if kind == "lfinito":
        return tfb.lfinito_sweep_multistep(
            rows, offs, canch, starts[i], w0[i].clone(), xa,
            invg[starts[i].long() // B], sc8, B)
    w = w0[i].clone()
    _, wpre = tfb.lsvrg_coeff_multistep(rows, offs, canch, starts[i], None,
                                        w, av, sc, B)
    return w, wpre


alone = [call(i) for i in range(2)]
torch.cuda.synchronize()
streams = [torch.cuda.Stream(dev) for _ in range(2)]
assert streams[0].cuda_stream != streams[1].cuda_stream
for _ in range(reps):
    outs = [None, None]
    for i in range(2):
        streams[i].wait_stream(torch.cuda.current_stream(dev))
    for i in range(2):
        with torch.cuda.stream(streams[i]):
            outs[i] = call(i)
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(a, b) for a, b in zip(outs[i], alone[i])), i
print("two streams: ok")
"""


@pytest.mark.parametrize("kind", ["lsvrg", "finito", "lfinito",
                                  "finito_stream", "proshi", "saga",
                                  "point_saga", "point_saga_stream", "ssnm",
                                  "ssnm_stream"])
@pytest.mark.parametrize("B", [128, 64])
def test_loopless_calls_on_two_streams_are_their_single_stream_runs(dev, B,
                                                                   kind):
    """Two calls of kernel #16, #9, #8, #14, #18, #3, #12, #15, #19 or
    #13 with small grids (B =
    128: one row a CTA, 128 CTAs; B = 64: 64, so both grids fit the card's
    132 SMs at once) queued together on two streams, 20 times: each gives
    its single-stream result bit for bit (each stream has its own
    grid-barrier word, ``fused_block._grid_barrier``; #9 and #14 write
    their table, anchors and point inside the launch, #18 its table, av
    and z, #3, #12 and #15 their table, iterate and av, #12 and #15 their
    shifted point, #19 and #13 their table, stored points, iterate, table mean
    and momentum point). Run in a child process with a time limit, so that a hung
    barrier fails the test and does not stall the suite."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", TWO_STREAMS, root, str(B),
                           kind],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "two streams: ok" in proc.stdout


# ---------------------------------------------------------------------------
# kernels #19, #13: SSNM; #12, #15: Point-SAGA
# ---------------------------------------------------------------------------

def _row_oracle(dev, N, n, kind, storage, seed=0):
    """A row oracle of ``kind`` on seeded rows, and its moduli's max."""
    from ciao_tpu_torch.oracles import (
        HuberRows, LogisticRows, PoissonRows, SquaredHingeRows,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    A = torch.randn(N, n, generator=gen, device=dev) / n ** 0.5
    b = torch.randn(N, generator=gen, device=dev)
    y = torch.sign(b)
    sq = float((A * A).sum(1).max())
    F, L = {
        "lsq": lambda: (LeastSquaresRows(A, b, float(N)), N * sq),
        "logistic": lambda: (LogisticRows(4.0 * A, y), 4.0 * sq),
        "huber": lambda: (HuberRows(A, b, delta=0.7, scale=float(N)),
                          N * sq),
        "sqhinge": lambda: (SquaredHingeRows(4.0 * A, y, scale=2.0),
                            32.0 * sq),
        "poisson": lambda: (PoissonRows(0.5 * A, torch.poisson(
            torch.full((N,), 2.0, device=dev), generator=gen)),
            0.25 * 2.72 * sq),
    }[kind]()
    return (F if storage == "f32" else F.with_storage(storage)), L


def _ssnm_state(dev, N, n, B, K, storage, seed=0):
    F, L = _row_oracle(dev, N, n, "lsq", storage, seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    x = 0.05 * torch.randn(n, generator=gen, device=dev)
    c = F.coeff_all(x)
    zb = x + 0.01 * torch.randn(N // B, n, generator=gen, device=dev)
    starts = (torch.randint(N // B, (K,), generator=gen, device=dev) * B).to(
        torch.int32)
    return F, L, (c, zb, x, F.apply_all(c) / N), starts


def _ssnm_scalars(F, L, N, B, tau, lam, dev):
    eta = 1.0 / (3.0 * tau * L)
    return torch.tensor([float(F.scale), eta, eta * lam, 1.0 / B, 1.0 / N,
                         0.0, tau, 0.0], device=dev)


def _run_state(fn, F, state, *args, **kw):
    st = [t.clone() for t in state]
    rows, offs = F.coeff_rows_data()
    fn(rows, offs, *args[:1], *st, *args[1:], rs=F.coeff_rows_scale(), **kw)
    return st


@pytest.mark.parametrize("kernel", ["ssnm_multistep",
                                    "ssnm_multistep_streamed"])
@pytest.mark.parametrize("storage,precision,n,tau", [
    ("f32", "highest", 128, 0.5), ("f32", "default", 128, 0.5),
    ("bf16", "highest", 128, 0.5), ("int8", "highest", 128, 0.5),
    ("f32", "highest", 128, 1.0), ("f32", "highest", 202, 0.5),
    ("int8", "highest", 200, 0.5)],
    ids=["f32", "f32-default", "bf16", "int8", "tau1", "f32-n202",
         "int8-n200"])
def test_ssnm_kernel_matches_plain_version(dev, kernel, storage, precision,
                                           n, tau):
    """K = 64 steps at N = 8,192, B = 128 (repeats included) of kernels
    #19 and #13 against their plain version: x and the stored points
    within 1e-6 of their largest entry for exact-f32 dots, 1e-5 where the
    dots round to bf16; c and gb within 10x that."""
    N, B, K = 8192, 128, 64
    F, L, state, starts = _ssnm_state(dev, N, n, B, K, storage)
    sc = _ssnm_scalars(F, L, N, B, tau, 0.01, dev)
    fn = getattr(tfb, kernel)
    before = fn.launches
    got = _run_state(fn, F, state, starts, sc, B, precision=precision)
    want = _run_state(tfb.ssnm_multistep_ref, F, state, starts, sc, B,
                      precision=precision)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    tol = 1e-5 if tfb._lowp(F.coeff_rows_data()[0], precision) else 1e-6
    assert float((want[2] - state[2]).abs().max()) > 0
    for i, (k, r) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(k).all())
        assert _rel(k, r) <= (10 * tol if i in (0, 3) else tol), (i,
                                                                  _rel(k, r))


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_ssnm_kernel_steps_and_masks_bit_for_bit(dev, storage):
    """A K-step call of #19 equals its K one-step calls bit for bit (y is
    formed once per step, by every CTA at step 0 or by the previous
    finish, with the same rounding); #13 equals #19; with f = 23 read on the device the
    masked steps write nothing, so the call equals the first 23 steps
    alone, f = K equals f None; two runs repeat bit for bit."""
    N, B, K = 8192, 128, 48
    F, L, state, starts = _ssnm_state(dev, N, 128, B, K, storage, seed=4)
    sc = _ssnm_scalars(F, L, N, B, 0.5, 0.01, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    whole = _run_state(tfb.ssnm_multistep, F, state, starts, sc, B)
    steps = [t.clone() for t in state]
    rows, offs = F.coeff_rows_data()
    for k in range(K):
        tfb.ssnm_multistep(rows, offs, starts[k:k + 1], *steps, sc, B,
                           rs=F.coeff_rows_scale())
    streamed = _run_state(tfb.ssnm_multistep_streamed, F, state, starts, sc,
                          B)
    masked = _run_state(tfb.ssnm_multistep_streamed, F, state, starts, sc, B,
                        f=torch.tensor([23], **i32))
    first = _run_state(tfb.ssnm_multistep, F, state, starts[:23], sc, B)
    full = _run_state(tfb.ssnm_multistep_streamed, F, state, starts, sc, B,
                      f=torch.tensor(K, **i32))
    again = _run_state(tfb.ssnm_multistep, F, state, starts, sc, B)
    torch.cuda.synchronize()
    for a, b in ((whole, steps), (whole, streamed), (masked, first),
                 (full, whole), (again, whole)):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    with pytest.raises(ValueError, match="zb"):
        _run_state(tfb.ssnm_multistep, F, (state[0], state[1][:-1],
                                           *state[2:]), starts, sc, B)


# (N, n, B) of #19 and #13 on hand-made revisits: the deep target's width
# (n = 128, B = 8,192: 64 rows a CTA, one stage a step, eight row groups of
# a warp, the ring up to six stages ahead) and the headline width (n =
# 1,024, B = 4,096: 32 rows a CTA, four f32 stages a step); d = 8 blocks
SSNM_EDGES = {"n128": (65536, 128, 8192), "n1024": (32768, 1024, 4096)}
# the blocks of the K = 24 steps: step 1 repeats step 0 (the same block
# twice in a row), step 5 step 3 (within the ring's lookahead), step 23
# step 0 (the call's first block at its last step), and block 7 is visited
# at steps 9 and 14 and by no step between, so a clamp count f = 12 cuts
# between the two visits
SSNM_REVISITS = (0, 0, 1, 2, 3, 2, 4, 5, 6, 7, 1, 3, 5, 4, 7, 6, 2, 2, 1, 3,
                 4, 6, 5, 0)


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("shape", list(SSNM_EDGES))
def test_ssnm_on_the_engine_takes_hand_made_revisits(dev, shape, storage):
    """Kernel #19, one cooperative launch a call, on ``SSNM_REVISITS``
    (the stored point zb_j and the table are written and read back inside
    the launch, and the finish forms the next step's y from the zb_j it
    has just stored where a block repeats), against
    ``ssnm_multistep_ref``: x and the stored points within 1e-6 of their
    largest entry, c and gb within 1e-5, over the whole call with exact
    f32 dots; with int8 rows (bf16 dots) step by step, each plain step
    taken once more by the kernel from the same state, within 1e-5 and
    1e-4 (a flipped bf16 rounding carries through every later step), the
    call equal to its one-step calls bit for bit. #13 with no clamp count
    equals #19 bit for bit, and with f = 12 read on the device (between
    the two visits of block 7) the first 12 steps alone."""
    N, n, B = SSNM_EDGES[shape]
    K = len(SSNM_REVISITS)
    F, L, state, _ = _ssnm_state(dev, N, n, B, K, storage, seed=61)
    starts = torch.tensor(SSNM_REVISITS, dtype=torch.int32, device=dev) * B
    sc = _ssnm_scalars(F, L, N, B, 0.5, 0.01, dev)
    before = tfb.ssnm_multistep.launches
    whole = _run_state(tfb.ssnm_multistep, F, state, starts, sc, B)
    torch.cuda.synchronize()
    assert tfb.ssnm_multistep.launches == before + 1
    lowp = storage != "f32"
    tol = 1e-5 if lowp else 1e-6
    if not lowp:
        pairs = [(whole, _run_state(tfb.ssnm_multistep_ref, F, state, starts,
                                    sc, B))]
    else:
        ref, chain, pairs = list(state), list(state), []
        for k in range(K):
            s1 = starts[k:k + 1]
            pairs.append((_run_state(tfb.ssnm_multistep, F, ref, s1, sc, B),
                          _run_state(tfb.ssnm_multistep_ref, F, ref, s1, sc,
                                     B)))
            chain = _run_state(tfb.ssnm_multistep, F, chain, s1, sc, B)
            ref = pairs[-1][1]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(whole, chain))
    torch.cuda.synchronize()
    for got, want in pairs:
        for i, (k_, r) in enumerate(zip(got, want)):
            assert bool(torch.isfinite(k_).all())
            assert _rel(k_, r) <= (10 * tol if i in (0, 3) else tol), (
                i, _rel(k_, r))
    assert float((pairs[-1][1][2] - state[2]).abs().max()) > 0
    f12 = torch.tensor([12], dtype=torch.int32, device=dev)
    pairs = ((_run_state(tfb.ssnm_multistep_streamed, F, state, starts, sc,
                         B), whole),
             (_run_state(tfb.ssnm_multistep_streamed, F, state, starts, sc, B,
                         f=f12),
              _run_state(tfb.ssnm_multistep, F, state, starts[:12], sc, B)))
    torch.cuda.synchronize()
    for a, b in pairs:
        assert all(torch.equal(u, v) for u, v in zip(a, b))


PS_KINDS = ["lsq", "logistic", "huber", "sqhinge", "poisson"]


def _ps_state(dev, N, n, B, K, kind, storage, seed=0):
    from ciao_tpu_torch.solvers.point_saga import _sqnorms

    F, L = _row_oracle(dev, N, n, kind, storage, seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    x = 0.05 * torch.randn(n, generator=gen, device=dev)
    c = F.coeff_all(x)
    starts = (torch.randint(N // B, (K,), generator=gen, device=dev) * B).to(
        torch.int32)
    return F, L, _sqnorms(F, N), (c, x, F.apply_all(c) / N), starts


def _ps_scalars(F, gamma, N, B, dev):
    return torch.tensor([float(getattr(F, "scale", 1.0)), gamma, 1.0 / B,
                         1.0 / N, float(F.coeff_mode),
                         float(getattr(F, "delta", 0.0))], device=dev)


def _ps_run(fn, F, na, state, starts, sc, B, inplace=False, **kw):
    st = state if inplace else [t.clone() for t in state]
    rows, offs = F.coeff_rows_data()
    fn(rows, offs, na, st[0], starts, st[1], st[2], sc, B,
       mode=F.coeff_mode, rs=F.coeff_rows_scale(), **kw)
    return st


@pytest.mark.parametrize("kernel", ["point_saga_multistep",
                                    "point_saga_multistep_streamed"])
@pytest.mark.parametrize("kind,storage,precision,n", [
    (k, s, "highest", 128) for k in PS_KINDS for s in ("f32", "int8")] + [
    ("lsq", "bf16", "highest", 128), ("logistic", "bf16", "highest", 128),
    ("lsq", "f32", "default", 128), ("logistic", "f32", "highest", 202)],
    ids=[f"{k}-{s}" for k in PS_KINDS for s in ("f32", "int8")] + [
        "lsq-bf16", "logistic-bf16", "lsq-f32-default", "logistic-n202"])
def test_point_saga_kernel_matches_plain_version(dev, kernel, kind, storage,
                                                 precision, n):
    """64 steps at N = 8,192, B = 128 (repeats included) of kernels #12 and
    #15 against their plain version in every oracle mode, at 10x the
    default γ, step by step: each step of the plain trajectory is taken
    once more by the kernel from the same state, x within 1e-6 of its
    largest entry for exact-f32 dots, 1e-5 where the dots round to bf16,
    c and av within 10x that. (Where the dots round to bf16 a last-bit
    difference of v can flip a component's bf16 rounding, so whole
    64-step calls drift apart by more: 1.1-2.7e-5 of x on the card.) The
    K-step call equals its one-step calls bit for bit (the next test)."""
    N, B, K = 8192, 128, 64
    F, L, na, state, starts = _ps_state(dev, N, n, B, K, kind, storage)
    sc = _ps_scalars(F, 10.0 / (3.0 * L), N, B, dev)
    fn = getattr(tfb, kernel)
    before = fn.launches
    tol = 1e-5 if tfb._lowp(F.coeff_rows_data()[0], precision) else 1e-6
    ref = [t.clone() for t in state]
    for k in range(K):
        got = _ps_run(fn, F, na, ref, starts[k:k + 1], sc, B,
                      precision=precision)
        _ps_run(tfb.point_saga_multistep_ref, F, na, ref, starts[k:k + 1],
                sc, B, precision=precision, inplace=True)
        torch.cuda.synchronize()
        for i, (g_, r) in enumerate(zip(got, ref)):
            assert bool(torch.isfinite(g_).all())
            assert _rel(g_, r) <= (tol if i == 1 else 10 * tol), (
                k, i, _rel(g_, r))
    assert fn.launches == before + K
    assert float((ref[1] - state[1]).abs().max()) > 0


@pytest.mark.parametrize("kind", ["lsq", "logistic", "poisson"])
def test_point_saga_kernel_steps_and_masks_bit_for_bit(dev, kind):
    """A K-step call of #12 equals its K one-step calls bit for bit, and
    each of #15's one-step calls, from the same state, equals #12's (one
    C entry on the engine); #15 equals #12; with f = 23 the masked steps
    write nothing, so the call equals #12 on the first 23 steps alone; f
    = K equals f None; runs repeat bit for bit; an unknown mode raises."""
    N, B, K = 8192, 128, 48
    F, L, na, state, starts = _ps_state(dev, N, 128, B, K, kind, "int8",
                                        seed=2)
    sc = _ps_scalars(F, 10.0 / (3.0 * L), N, B, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    run = lambda fn, st=starts, **kw: _ps_run(  # noqa: E731
        getattr(tfb, fn), F, na, state, st, sc, B, **kw)
    whole = run("point_saga_multistep")
    steps = [t.clone() for t in state]
    for k in range(K):
        s1 = starts[k:k + 1]
        other = _ps_run(tfb.point_saga_multistep_streamed, F, na, steps, s1,
                        sc, B)
        _ps_run(tfb.point_saga_multistep, F, na, steps, s1, sc, B,
                inplace=True)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(other, steps)), k
    pairs = ((whole, steps), (run("point_saga_multistep_streamed"), whole),
             (run("point_saga_multistep_streamed",
                  f=torch.tensor([23], **i32)),
              run("point_saga_multistep", starts[:23])),
             (run("point_saga_multistep_streamed", f=torch.tensor(K, **i32)),
              whole), (run("point_saga_multistep"), whole))
    torch.cuda.synchronize()
    for a, b in pairs:
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    rows_offs = F.coeff_rows_data()
    with pytest.raises(ValueError, match="mode"):
        tfb.point_saga_multistep(rows_offs[0], rows_offs[1], na,
                                 state[0].clone(), starts, state[1].clone(),
                                 state[2].clone(), sc, B, mode=5,
                                 rs=F.coeff_rows_scale())


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("kind", ["lsq", "logistic"])
@pytest.mark.parametrize("shape", list(SSNM_EDGES))
def test_point_saga_on_the_engine_takes_hand_made_revisits(dev, shape, kind,
                                                           storage):
    """Kernel #15, one cooperative launch a call, on ``SSNM_REVISITS`` (a
    block twice in a row, within the ring's lookahead, the call's first
    block at its last step; the table written and read back inside the
    launch) at the deep target's width (n = 128, B = 8,192: one stage a
    step, each CTA's 64 rows solved at once, eight row groups of a warp)
    and the headline's (n = 1,024, B = 4,096: four f32 stages a step,
    logistic rows solved after all of them), at 10x the default γ, step by
    step against the plain version (each plain step taken once more by the
    kernel from the same state; x within 1e-6 of its largest entry, 1e-5
    where the dots round to bf16, c and av within 10x that); the call
    equals its one-step calls and #12 bit for bit, and with f = 12 read on
    the device (between the two visits of block 7) #12 on the first 12
    steps alone."""
    N, n, B = SSNM_EDGES[shape]
    K = len(SSNM_REVISITS)
    F, L, na, state, _ = _ps_state(dev, N, n, B, K, kind, storage, seed=63)
    starts = torch.tensor(SSNM_REVISITS, dtype=torch.int32, device=dev) * B
    sc = _ps_scalars(F, 10.0 / (3.0 * L), N, B, dev)
    fn = tfb.point_saga_multistep_streamed
    tol = 1e-5 if storage != "f32" else 1e-6
    before = fn.launches
    whole = _ps_run(fn, F, na, state, starts, sc, B)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = [t.clone() for t in state]
    chain = [t.clone() for t in state]
    for k in range(K):
        s1 = starts[k:k + 1]
        got = _ps_run(fn, F, na, ref, s1, sc, B)
        _ps_run(fn, F, na, chain, s1, sc, B, inplace=True)
        _ps_run(tfb.point_saga_multistep_streamed_ref, F, na, ref, s1, sc, B,
                inplace=True)
        torch.cuda.synchronize()
        for i, (g_, r) in enumerate(zip(got, ref)):
            assert bool(torch.isfinite(g_).all())
            assert _rel(g_, r) <= (tol if i == 1 else 10 * tol), (
                k, i, _rel(g_, r))
    assert float((ref[1] - state[1]).abs().max()) > 0
    f12 = torch.tensor([12], dtype=torch.int32, device=dev)
    pairs = ((whole, chain),
             (whole, _ps_run(tfb.point_saga_multistep, F, na, state, starts,
                             sc, B)),
             (_ps_run(fn, F, na, state, starts, sc, B, f=f12),
              _ps_run(tfb.point_saga_multistep, F, na, state, starts[:12],
                      sc, B)))
    torch.cuda.synchronize()
    for a, b in pairs:
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_ssnm_and_point_saga_facades_send_every_gated_run_to_a_kernel(
        dev, monkeypatch):
    """On the card the SSNM facade with NormL1 and the PointSAGA facade
    with block sampling run every step on their kernels (#19 within JAX's
    resident bounds, #13 beyond them; #12 for N ≤ RESIDENT_MAX_ROWS, #15
    above it), ``LAUNCH_STEPS`` a call and the remainder in one more, with
    no fallback warning and no other step kernel; the objectives fall. A
    closed gate (SSNM with an IndBox prox) warns and runs stepwise."""
    import math
    import warnings

    from ciao_tpu_torch import SSNM, PointSAGA, runtime
    from ciao_tpu_torch.monitor import objective
    from ciao_tpu_torch.prox import IndBox, NormL1, Zero
    from ciao_tpu_torch.solvers import finito as tfinito
    from ciao_tpu_torch.solvers import point_saga as tps

    N, n, B = 4096, 64, 128
    g = NormL1(torch.tensor(0.01, device=dev))
    x0 = torch.zeros(n, device=dev)
    names = ("ssnm_multistep", "ssnm_multistep_streamed",
             "point_saga_multistep", "point_saga_multistep_streamed",
             "saga_coeff_multistep", "saga_coeff_multistep_streamed",
             "finito_coeff_multistep")

    def run(solver, F, L, gg, kname, calls):
        before = {k: getattr(tfb, k).launches for k in names}
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            x, it = solver(x0, F=F, g=gg, L=L)
        d = {k: getattr(tfb, k).launches - before[k] for k in names}
        assert d[kname] == calls and all(
            v == 0 for k, v in d.items() if k != kname), (kname, d)
        gz = Zero() if gg is None else gg
        assert float(objective(F, gz, x)) < float(objective(F, gz, x0))

    F, L = _row_oracle(dev, N, n, "lsq", "f32", seed=5)
    run(SSNM(maxit=201, batch=B), F, torch.full((N,), L, device=dev), g,
        "ssnm_multistep", 2)
    for kind in PS_KINDS:
        Fk, Lk = _row_oracle(dev, N, n, kind, "int8", seed=6)
        run(PointSAGA(maxit=130, batch=B, block_sampling=True), Fk,
            torch.full((N,), Lk, device=dev), None, "point_saga_multistep",
            2)
    monkeypatch.setattr(tfinito, "RESIDENT_MAX_ROWS", N // 2)
    monkeypatch.setattr(tps, "RESIDENT_MAX_ROWS", N // 2)
    run(SSNM(maxit=130, batch=B), F, torch.full((N,), L, device=dev), g,
        "ssnm_multistep_streamed", 2)
    run(PointSAGA(maxit=130, batch=B, block_sampling=True), F,
        torch.full((N,), L, device=dev), None,
        "point_saga_multistep_streamed", 2)
    runtime.reset_fallback_warnings()
    before = tfb.ssnm_multistep.launches
    with pytest.warns(UserWarning, match="SSNM"):
        SSNM(maxit=3, batch=B)(x0, F=F, g=IndBox(-math.inf, 1.0),
                               L=torch.full((N,), L, device=dev))
    assert tfb.ssnm_multistep.launches == before
    runtime.reset_fallback_warnings()



# ---------------------------------------------------------------------------
# kernel #7: coeff_value_apply_all, and kernel #6 pinned bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4],
                         ids=["lsq", "logistic", "huber", "sqhinge",
                              "poisson"])
@pytest.mark.parametrize("storage,precision,N,n", APPLY_CASES, ids=APPLY_IDS)
def test_value_apply_kernel_matches_plain_version(dev, storage, precision, N,
                                                  n, mode):
    """Every formula mode (labels ±1 for the classification modes, counts
    for Poisson), ragged N and rows that are not whole 16-byte chunks: the
    value within 1e-6 of Σ|f_i|; c within 1e-6 of its largest entry (1e-5
    with bf16 dots), gsum within 1e-6 (1e-4 with bf16 dots: a weighted
    coefficient whose bf16 rounding flips moves it by 2^-8·|c_i·a_i|, as
    kernel #6's test allows); one launch; c and gsum are kernel #6's to
    the bit (the same tiles)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(10 + mode)
    F = LeastSquaresRows(torch.randn(N, n, generator=gen, device=dev),
                         torch.randn(N, generator=gen, device=dev), float(N))
    if storage != "f32":
        F = F.with_storage(storage)
    rows, b = F.coeff_rows_data()
    if mode in (1, 3):
        b = torch.sign(b)
    elif mode == 4:
        b = torch.floor(2.0 * b.abs())
    rs = F.coeff_rows_scale()
    z = _apply_z(n, gen, dev)
    sc = torch.tensor([N if mode in (0, 2) else 1.0, mode, 0.5], device=dev)
    before = tfb.coeff_value_apply_all.launches
    kv, kc, kg = tfb.coeff_value_apply_all(rows, b, z, sc,
                                           precision=precision, rs=rs)
    rv, rc, rg = tfb.coeff_value_apply_all_ref(rows, b, z, sc,
                                               precision=precision, rs=rs)
    torch.cuda.synchronize()
    assert tfb.coeff_value_apply_all.launches == before + 1
    r = tfb._apply_margins_ref(rows, z, precision, rs)[1]
    vabs = float(tfb._value_formula(sc[1], r, b, sc[0], sc[2]).abs().sum())
    lowp = tfb._lowp(rows, precision)
    assert abs(float(kv) - float(rv)) <= 1e-6 * vabs
    assert _rel(kc, rc) <= (1e-5 if lowp else 1e-6)
    assert _rel(kg, rg) <= (1e-4 if lowp else 1e-6)
    c6, g6 = tfb.coeff_apply_all(rows, b, z, sc, precision=precision, rs=rs)
    assert torch.equal(kc, c6) and torch.equal(kg, g6)


def _golden_inputs(dev, storage, N=8192, n=256):
    """Exact dyadic rows, offsets and z (no generator, no libm): the inputs
    of kernel #6's pinned digests."""
    i = torch.arange(N)[:, None]
    j = torch.arange(n)[None, :]
    F = LeastSquaresRows((((i * 31 + j * 17) % 97) - 48).float() / 64,
                         ((torch.arange(N) * 13 % 29) - 14).float() / 8, 1.0)
    if storage != "f32":
        F = F.with_storage(storage)
    A, b = F.coeff_rows_data()
    rs = F.coeff_rows_scale()
    z = ((torch.arange(n) * 7 % 11) - 5).float() / 256
    return A.to(dev), b.to(dev), z.to(dev), None if rs is None else rs.to(dev)


# sha256 (first 16 hex digits) of c and gsum of kernel #6 from the walk of
# 48 KB tiles, on _golden_inputs with 64 CTAs (43 at int8 rows: one a tile)
# (NVIDIA H100 80GB HBM3, nvcc of CUDA 12.8)
APPLY_GOLDEN = {
    ("f32", "highest", 0): "4ed0a7e6a73817d1",
    ("f32", "highest", 1): "d39380cf7f2921d4",
    ("f32", "default", 2): "fbb6d4962361206a",
    ("bf16", "highest", 3): "4fe538cb1badfe5b",
    ("int8", "highest", 4): "812e74b895accb8d",
}


def apply_digest(dev, storage, precision, mode, ctas=64):
    """Kernel #6's c and gsum on ``_golden_inputs`` with ``ctas`` CTAs, or
    one a tile where the tiles are fewer (the wrapper's count depends on
    the card), as a digest."""
    import hashlib

    A, b, z, rs = _golden_inputs(dev, storage)
    N, n = A.shape
    rows = tfb._apply_rows(n, A.element_size())
    ctas = min(ctas, -(-N // rows))  # at most one a tile: 43 at int8
    sc = torch.tensor([1.0, mode, 0.5], device=dev)
    c = torch.empty(N, device=dev)
    g = torch.empty(n, device=dev)
    hi = torch.empty(ctas, n, device=dev)
    lo = torch.empty(ctas, n, device=dev)
    tfb._call("coeff_apply_all", dev, A.data_ptr(), tfb._STORAGE_CODES[A.dtype],
              int(tfb._lowp(A, precision)), b.data_ptr(), tfb._ptr(rs),
              z.data_ptr(), sc.data_ptr(), c.data_ptr(), g.data_ptr(),
              hi.data_ptr(), lo.data_ptr(), N, n, rows, ctas)
    torch.cuda.synchronize()
    h = hashlib.sha256(c.cpu().numpy().tobytes())
    h.update(g.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("storage,precision,mode", list(APPLY_GOLDEN),
                         ids=[f"{s}-{p}-mode{m}" for s, p, m in APPLY_GOLDEN])
def test_apply_kernel_is_bit_for_bit_its_earlier_output(dev, storage,
                                                        precision, mode):
    """Kernel #6 shares its body with kernel #7 (``csrc/apply_rows.cuh``,
    the value column off): its c and gsum keep their pinned bits."""
    assert apply_digest(dev, storage, precision, mode) == APPLY_GOLDEN[
        storage, precision, mode]


def test_value_apply_kernel_repeats_bit_for_bit_and_checks_arguments(dev):
    A, b, z, rs = _golden_inputs(dev, "int8")
    sc = torch.tensor([1.0, 1.0, 0.0], device=dev)
    outs = [tfb.coeff_value_apply_all(A, b, z, sc, rs=rs) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*outs))
    A, b = A[:1024, :64].float().contiguous(), b[:1024].contiguous()
    z = z[:64].contiguous()
    with pytest.raises(ValueError, match="scalars"):
        tfb.coeff_value_apply_all(A, b, z, torch.zeros(8, device=dev))
    with pytest.raises(ValueError, match="z has shape"):
        tfb.coeff_value_apply_all(A, b, z[:32], sc)
    with pytest.raises(ValueError, match="on cpu"):
        tfb.coeff_value_apply_all(A, b.cpu(), z, sc)
    with pytest.raises(ValueError, match="rs"):
        tfb.coeff_value_apply_all(A.to(torch.int8), b, z, sc)


def test_panoc_and_splitting_facades_run_on_the_kernels(dev, monkeypatch):
    """On the card, with the gate open: every FBE evaluation of PANOC and
    ZeroFPR (fixed, adaptive, tol) is one launch of kernel #7 and no
    other kernel runs, the two-product read is never taken; Davis-Yin and
    Condat-Vũ take kernel #6 once a step. The objectives fall."""
    import warnings

    from ciao_tpu_torch import CondatVu, DavisYin, PANOC, ZeroFPR
    from ciao_tpu_torch.monitor import objective
    from ciao_tpu_torch.ops.linmap import FirstDifference
    from ciao_tpu_torch.prox import IndBox, NormL1
    from ciao_tpu_torch.solvers import panoc as tpanoc

    N, n = 4224, 64
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    A = torch.randn(N, n, generator=gen, device=dev)
    F = LeastSquaresRows(A, torch.randn(N, generator=gen, device=dev),
                         float(N))
    L = (A * A).sum(1) * N
    g = NormL1(torch.tensor(0.01, device=dev))
    x0 = torch.zeros(n, device=dev)
    evals = []
    real_eval = tpanoc._eval_fbe

    def counted(*args, **kw):
        evals.append(1)
        return real_eval(*args, **kw)

    def refused(*args, **kw):
        raise AssertionError("the two-product read ran on the card")

    monkeypatch.setattr(tpanoc, "_eval_fbe", counted)
    monkeypatch.setattr(F, "value_sum_and_grad_sum_all", refused)
    names = ("coeff_value_apply_all", "coeff_apply_all",
             "saga_coeff_multistep", "svrg_coeff_multistep")
    for solver, kw in ((PANOC(maxit=20), dict(L=L)),
                       (ZeroFPR(maxit=20), dict(L=L)),
                       (PANOC(maxit=20, tol=1e-3), dict(L=L)),
                       (ZeroFPR(maxit=20), {})):
        evals.clear()
        before = {k: getattr(tfb, k).launches for k in names}
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            x, _ = solver(x0, F=F, g=g, **kw)
        d = {k: getattr(tfb, k).launches - before[k] for k in names}
        assert d == {"coeff_value_apply_all": len(evals),
                     "coeff_apply_all": 0, "saga_coeff_multistep": 0,
                     "svrg_coeff_multistep": 0}, d
        assert len(evals) >= 2
        assert float(objective(F, g, x)) < float(objective(F, g, x0))
    for solver, kw in ((DavisYin(maxit=21), dict(h=IndBox(-1.0, 1.0))),
                       (CondatVu(maxit=21),
                        dict(h=NormL1(0.05), K=FirstDifference()))):
        before = {k: getattr(tfb, k).launches for k in names}
        x, it = solver(x0, F=F, g=g, L=L, **kw)
        d = {k: getattr(tfb, k).launches - before[k] for k in names}
        assert it == 21 and d == {"coeff_value_apply_all": 0,
                                  "coeff_apply_all": 20,
                                  "saga_coeff_multistep": 0,
                                  "svrg_coeff_multistep": 0}, d
        assert float(objective(F, g, x)) < float(objective(F, g, x0))


# ---------------------------------------------------------------------------
# sparse rows: no kernel serves them, by design
# ---------------------------------------------------------------------------

SPARSE_KINDS = ["ell_lsq", "hybrid_lsq", "ell_logistic", "hybrid_logistic"]


def _sparse_oracle(kind, device):
    """A power-law f64 matrix (four near-dense columns, a sparse tail, row
    5 all padding) as the sparse oracle ``kind`` on ``device``."""
    import numpy as np

    from ciao_tpu_torch.oracles import (
        HybridSparseLeastSquares, HybridSparseLogistic,
        SparseLeastSquaresELL, SparseLogisticELL,
    )

    rng = np.random.default_rng(7)
    N, n = 256, 64
    A = np.zeros((N, n))
    for c in (5, 11, 30, 41):
        m = rng.random(N) < 0.9
        A[m, c] = rng.standard_normal(m.sum())
    for i in range(N):
        cols = rng.choice(n, size=rng.integers(0, 7), replace=False)
        A[i, cols] = rng.standard_normal(len(cols))
    A[5] = 0.0
    b = A @ rng.standard_normal(n) + 0.05 * rng.standard_normal(N)
    y = np.where(b > 0, 1.0, -1.0)
    return {"ell_lsq": lambda: SparseLeastSquaresELL.from_dense(
                A, b, float(N), device=device),
            "hybrid_lsq": lambda: HybridSparseLeastSquares.from_dense(
                A, b, float(N), D=4, device=device),
            "ell_logistic": lambda: SparseLogisticELL.from_dense(
                A, y, device=device),
            "hybrid_logistic": lambda: HybridSparseLogistic.from_dense(
                A, y, D=4, device=device)}[kind]()


@pytest.mark.parametrize("kind", SPARSE_KINDS)
def test_sparse_protocols_on_the_card_match_the_cpu(dev, kind):
    """Every protocol method of the four sparse classes on the card
    against the same call on the CPU, in f64: within 1e-12 of the largest
    entry (the card's scatter-adds sum with atomics, in another order)."""
    cpu = torch.device("cpu")
    P, G = _sparse_oracle(kind, cpu), _sparse_oracle(kind, dev)
    gen = torch.Generator().manual_seed(2)
    N, n = P.num_terms, P.dim
    x = torch.randn(n, generator=gen, dtype=torch.float64)
    x2 = torch.randn(n, generator=gen, dtype=torch.float64)
    xs = torch.randn(4, n, generator=gen, dtype=torch.float64)
    idx = torch.tensor([3, 5, 99, 64])
    mask = torch.tensor([True, True, False, True])
    w4 = torch.randn(4, generator=gen, dtype=torch.float64)
    w16 = torch.randn(16, generator=gen, dtype=torch.float64)
    wN = torch.randn(N, generator=gen, dtype=torch.float64)
    cases = [
        ("margin_all", (x,)), ("coeff_all", (x,)), ("coeff_batch", (x, idx)),
        ("coeff_block", (x, 0, 16)), ("coeff_block", (x, 16, 16)),
        ("apply_rows", (w4, idx)), ("apply_rows_block", (w16, 0, 16)),
        ("apply_all", (wN,)), ("grad_sum_all", (x,)),
        ("grad_sum_batch", (x, idx, mask)), ("grad_sum_diff", (x, x2, idx)),
        ("grad_sum_diff_block", (x, x2, 0, 16)), ("grad_block", (x, 0, 16)),
        ("grad_batch", (x, idx)), ("grad_pointwise", (xs, idx)),
        ("value_and_grad_i", (x, 5)), ("value_and_grad_i", (x, 7)),
        ("value_sum_all", (x,)), ("value_sum_and_grad_sum_all", (x,)),
        ("hess_weight_from_margin", (x[:1].repeat(N), 0.3)),
    ]

    def on(a, d):
        return a.to(d) if isinstance(a, torch.Tensor) else a

    for name, args in cases:
        want = getattr(P, name)(*args)
        got = getattr(G, name)(*(on(a, dev) for a in args))
        pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
        for g_, w_ in pairs:
            assert g_.device.type == "cuda", name
            err = float((g_.cpu() - w_).abs().max())
            assert err <= 1e-12 * max(float(w_.abs().max()), 1e-300), (
                name, err)
    # a device start gathers the rows a host start slices
    assert torch.equal(G.coeff_block(on(x, dev), torch.tensor(16, device=dev),
                                     16),
                       G.coeff_block(on(x, dev), 16, 16))


def test_sparse_saga_facade_on_the_card_launches_no_kernel(dev):
    """The SAGA facade with block sampling on the port's planted sparse
    Lasso: no kernel wrapper launches, the objective falls on both
    layouts, and the fallback warning names the hybrid for pure ELL and
    stays silent for the hybrid."""
    import warnings

    from ciao_tpu_torch import SAGA, runtime
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.utils import make_sparse_lasso_ell

    prob = make_sparse_lasso_ell(N=4_096, n=512, hot=64, k_hot=8, k_cold=4,
                                 p=16, rho=1.0, seed=0, device=dev)
    g = NormL1(torch.tensor(prob.lam, device=dev))
    wrappers = [f for f in vars(tfb).values()
                if callable(f) and hasattr(f, "launches")]
    assert len(wrappers) >= 19
    before = [f.launches for f in wrappers]
    x0 = torch.zeros(512, device=dev)
    runtime.reset_fallback_warnings()
    try:
        for F, warns in ((prob.ell, True), (prob.hybrid, False)):
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                x, _ = SAGA(maxit=512, batch=256, block_sampling=True)(
                    x0, F=F, g=g, L=prob.L)
            ours = [str(w.message) for w in seen
                    if "stepwise PyTorch path" in str(w.message)]
            assert (len(ours) == 1 and "HybridSparseLeastSquares" in ours[0]
                    if warns else not ours), ours
            assert x.device.type == "cuda"
            assert float(F.value_sum_all(x)) < float(F.value_sum_all(x0))
    finally:
        runtime.reset_fallback_warnings()
    assert [f.launches for f in wrappers] == before


def _fused_lasso(dev, N=8_192, n=256, seed=0):
    """tests/test_deep_pd.py:67's planted fused lasso, f32 rows on ``dev``."""
    from ciao_tpu_torch.utils import make_fused_lasso_planted

    p = make_fused_lasso_planted(N=N, n=n, jumps=8, seed=seed)
    F = LeastSquaresRows(torch.tensor(p.A, dtype=torch.float32, device=dev),
                         torch.tensor(p.b, dtype=torch.float32, device=dev),
                         float(N))
    return p, F


def test_deep_solve_pd_defaults_to_the_card_and_certifies(dev):
    """``deep_solve_pd`` with an x0 that is no tensor and rows built on the
    CPU runs on the card; the planted fused lasso certifies there with rel
    ≤ 1e-8 against the exact f64 optimum, flat runs exact, and no kernel
    wrapper launches (the route has no kernel)."""
    import numpy as np

    from ciao_tpu_torch import FirstDifference, NormL1, deep_solve_pd

    p, F = _fused_lasso(torch.device("cpu"))
    wrappers = [f for f in vars(tfb).values()
                if callable(f) and hasattr(f, "launches")]
    before = [f.launches for f in wrappers]
    x, info = deep_solve_pd(np.zeros(256, np.float32), F,
                            h=NormL1(torch.tensor(p.lam)),
                            K=FirstDifference(), N=8_192, chunk=1_024,
                            chunk_steps=512, max_steps=32_768)
    assert x.device.type == "cuda" and F.A.device.type == "cuda"
    assert info.refined and info.certified
    xn = x.double().cpu().numpy()
    rel = (p.cost(xn) - p.f_star) / abs(p.f_star)
    assert 0 <= rel <= 1e-8
    true_J = np.abs(np.diff(p.x_star)) > 0
    assert np.all(np.diff(xn)[~true_J] == 0.0)
    assert [f.launches for f in wrappers] == before


def test_refinements_repeat_bit_for_bit_on_the_card(dev):
    """``tv_refine`` and ``tv_refine3`` run twice on one iterate give the
    same bits: A·S is a product against the one-hot indicator, with no
    scatter-add, so the certificate repeats."""
    import numpy as np

    from ciao_tpu_torch import tv_refine, tv_refine3

    p, F = _fused_lasso(dev, N=4_096, n=128)
    rng = np.random.default_rng(11)
    x = torch.tensor(p.x_star + 1e-6 * rng.standard_normal(128),
                     dtype=torch.float32, device=dev)
    (x1, c1, v1), (x2, c2, v2) = (tv_refine(F, x, p.lam, chunk=1_024)
                                  for _ in range(2))
    assert c1 and c1 == c2 and x1.device.type == "cuda"
    assert torch.equal(x1, x2) and np.array_equal(v1, v2)
    (y1, d1), (y2, d2) = (tv_refine3(F, x, 0.0, p.lam, chunk=1_024)
                          for _ in range(2))
    assert d1 and d1 == d2 and torch.equal(y1, y2)


# ---------------------------------------------------------------------------
# complex rows and iterates, Precompose and CustomOracle: no kernel serves
# them (the JAX package sends a complex iterate past every kernel gate)
# ---------------------------------------------------------------------------

def _complex_rows(N=256, n=16, seed=0):
    """Truly complex rows and offsets (c128, on the CPU) with L_i = N‖a_i‖²."""
    gen = torch.Generator().manual_seed(seed)
    A = torch.randn(N, n, dtype=torch.complex128, generator=gen)
    b = torch.randn(N, dtype=torch.complex128, generator=gen)
    return A, b, N * torch.linalg.vector_norm(A, dim=1) ** 2


def _complex_facades(N, B):
    from ciao_tpu_torch import (
        FISTA, LSVRG, PANOC, SAGA, SARAH, SSNM, SVRG, CondatVu, DavisYin,
        Finito, Katyusha, LKatyusha, PointSAGA, Proshi, ZeroFPR,
    )

    blk = dict(batch=B, block_sampling=True)
    return {"saga": SAGA(maxit=65, **blk),
            "sag": SAGA(maxit=65, SAG_flag=True, **blk),
            "svrg": SVRG(maxit=3, m=N // B, gamma=1e-4, **blk),
            "finito": Finito(maxit=65, minibatch=(True, B), sweeping=2),
            "lfinito": Finito(maxit=3, minibatch=(True, B), sweeping=2,
                              LFinito=True),
            "finito_adaptive": Finito(maxit=65, sweeping=2, adaptive=True),
            "fista": FISTA(maxit=20), "katyusha": Katyusha(maxit=2, **blk),
            "sarah": SARAH(maxit=2, **blk), "lsvrg": LSVRG(maxit=65, **blk),
            "lkatyusha": LKatyusha(maxit=65, **blk),
            "ssnm": SSNM(maxit=65, batch=B),
            "point_saga": PointSAGA(maxit=65, **blk),
            "panoc": PANOC(maxit=10), "zerofpr": ZeroFPR(maxit=10),
            "davis_yin": DavisYin(maxit=20), "condat_vu": CondatVu(maxit=20),
            "proshi": Proshi(maxit=33, minibatch=(True, B), sweeping=2)}


@pytest.mark.parametrize("name", list(_complex_facades(256, 32)))
def test_complex_facades_on_the_card_match_the_cpu(dev, name):
    """Each complex facade in c128 on the card walks the CPU's trajectory
    (the same draws: block starts and coins are hashes of (seed, it), and
    the Finito sweeps are cyclic),
    to 1e-9 of the largest entry, with the dtype kept, no kernel launched
    and no fallback warning."""
    import warnings

    from ciao_tpu_torch import NormL1, runtime

    A, b, L = _complex_rows()
    solver = _complex_facades(256, 32)[name]
    kw = dict(L=L.numpy(), N=256)
    if name != "point_saga":
        kw["g"] = NormL1(0.05)
    wrappers = [f for f in vars(tfb).values()
                if callable(f) and hasattr(f, "launches")]
    before = [f.launches for f in wrappers]
    runtime.reset_fallback_warnings()
    xs = {}
    for where in ("cpu", "cuda"):
        F = LeastSquaresRows(A.to(where), b.to(where), 256.0)
        x0 = torch.zeros(16, dtype=torch.complex128, device=where)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            xs[where], _ = solver(x0, F=F, **kw)
    assert [f.launches for f in wrappers] == before
    got, want = xs["cuda"], xs["cpu"]
    assert got.device.type == "cuda" and got.dtype == torch.complex128
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-9 * float(want.abs().max()))


def test_complex64_iterate_closes_every_gate_on_the_card(dev):
    """A complex64 iterate on f32-sized complex rows on the card: every
    kernel gate is closed (each asks for f32 iterates), SAGA with block
    sampling warns of no fallback and launches no kernel, and its cost
    falls."""
    import warnings

    from ciao_tpu_torch import SAGA, NormL1, runtime
    from ciao_tpu_torch.prox import Zero

    A, b, L = _complex_rows(N=4_096, n=128)
    F = LeastSquaresRows(A.to(dev, torch.complex64),
                         b.to(dev, torch.complex64), 4_096.0)
    x0 = torch.zeros(128, dtype=torch.complex64, device=dev)
    for gate in (tfb.full_grad_available(F, x0),
                 tfb.saga_multistep_available(F, Zero(), x0, 512),
                 tfb.proshi_multistep_available(F, Zero(), x0, 512)):
        assert gate is False
    wrappers = [f for f in vars(tfb).values()
                if callable(f) and hasattr(f, "launches")]
    before = [f.launches for f in wrappers]
    runtime.reset_fallback_warnings()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        x, _ = SAGA(maxit=129, batch=512, block_sampling=True)(
            x0, F=F, g=NormL1(0.05), L=L.numpy())
    assert [f.launches for f in wrappers] == before
    assert x.dtype == torch.complex64
    assert float(F.value_sum_all(x)) < float(F.value_sum_all(x0))


def test_custom_oracle_and_precompose_on_the_card(dev):
    """CustomOracle's data move with ``.to``; its batched paths (gathered
    data, vmapped gradient) on the card equal the CPU's, on a complex
    iterate with the rows' convention conj(a)·r; Precompose of a scalar
    logistic loss equals LogisticRows on the card."""
    from ciao_tpu_torch import CustomOracle, Precompose
    from ciao_tpu_torch.oracles import LogisticRows

    A, b, _ = _complex_rows(N=64, n=8)

    def fun(x, d):
        r = d["a"] @ x - d["b"]
        return 0.5 * (r.real ** 2 + r.imag ** 2)

    Fc = CustomOracle({"a": A, "b": b}, fun=fun)
    Fd = CustomOracle({"a": A, "b": b}, fun=fun).to(dev)
    assert Fd.data["a"].device.type == "cuda"
    x = torch.randn(8, dtype=torch.complex128)
    idx = torch.tensor([5, 0, 63, 5])
    for got, want in zip(Fd.value_and_grad_batch(x.to(dev), idx.to(dev)),
                         Fc.value_and_grad_batch(x, idx)):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-12, atol=1e-12)
    rows = LeastSquaresRows(A.to(dev), b.to(dev), 1.0)
    torch.testing.assert_close(Fd.grad_sum_all(x.to(dev)),
                               rows.grad_sum_all(x.to(dev)), rtol=1e-12,
                               atol=1e-12)
    X = torch.randn(512, 16, device=dev)
    y = torch.where(torch.rand(512, device=dev) > 0.5, 1.0, -1.0)
    pre = Precompose(CustomOracle({"y": y}, fun=lambda v, d: (
        torch.nn.functional.softplus(-d["y"] * v[0]))), X[:, None, :])
    folded = LogisticRows(X, y)
    z = torch.randn(16, device=dev)
    for got, want in zip(pre.value_and_grad_all(z),
                         folded.value_and_grad_all(z)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the sparse plant's repeatability, checkpoints and the entry point
# ---------------------------------------------------------------------------

def _fields(node, path="x"):
    """(path, value) of every tensor and scalar of a NamedTuple tree."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        for f, v in zip(node._fields, node):
            yield from _fields(v, f"{path}.{f}")
    elif hasattr(node, "named_buffers"):
        for f, v in node.named_buffers():
            yield f"{path}.{f}", v
    else:
        yield path, node


def _bit_equal(a, b):
    la, lb = list(_fields(a)), list(_fields(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device, p
            assert torch.equal(x, y), p
        else:
            assert x == y, p


def test_sparse_plant_is_a_function_of_its_seed(dev):
    """Two builds of ``make_sparse_lasso_ell`` at one seed on the card are
    bit-equal, every field of both layouts, x*, f* and L, at a shape whose
    power-law columns repeat thousands of times (the column sums that pick
    the support, and the popularity CDFs, are summed in a fixed order, not
    by atomics or a CUDA scan; n = 65,536 is the rcv1 shape's width)."""
    from ciao_tpu_torch.utils.problems import make_sparse_lasso_ell

    kw = dict(N=131_072, n=65_536, hot=1_024, k_hot=24, k_cold=8, p=64,
              rho=1.0, seed=5, device=dev)
    a = make_sparse_lasso_ell(**kw)
    b = make_sparse_lasso_ell(**kw)
    assert int(torch.bincount(a.ell.idx.reshape(-1).long()).max()) > 1_000
    _bit_equal(a, b)
    assert a.f_star == b.f_star and a.lam == b.lam


def test_async_save_while_the_solver_steps(dev, tmp_path):
    """A full-table SAGA state (kernel #1 a step) saved with save_async,
    then 16 more steps while the write is in flight: the file holds the
    snapshot bit for bit, and a resume from it equals the straight run
    bit for bit."""
    from ciao_tpu_torch import SAGA, NormL1, checkpoint
    from ciao_tpu_torch.solvers import loop, take

    gen = torch.Generator(device=dev).manual_seed(3)
    N, n, B = 16_384, 512, 1_024
    A = torch.randn(N, n, generator=gen, device=dev)
    F = LeastSquaresRows(A, torch.randn(N, generator=gen, device=dev),
                         float(N))
    L = (A * A).sum(1) * N
    solver = SAGA(table="full", block_sampling=True, batch=B)

    def it():
        return solver.iterator(torch.zeros(n, device=dev), F=F,
                               g=NormL1(0.1), L=L)

    before = tfb.saga_block_update.launches
    straight = loop(take(iter(it()), 33))
    assert tfb.saga_block_update.launches - before == 32
    stream = iter(it())
    mid = loop(take(stream, 17))
    snap = [t.clone() for t in (mid.s, mid.z, mid.av)]
    mgr = checkpoint.save_async(tmp_path / "full.pt", mid)
    state = mid
    for _ in range(16):
        state = next(stream)
    mgr.wait_until_finished()
    assert torch.equal(state.z, straight.z)
    back = checkpoint.load(tmp_path / "full.pt", device=dev)
    for a, b in zip((back.s, back.z, back.av), snap):
        assert a.device == b.device and torch.equal(a, b)
    resumed = loop(take(checkpoint.resume_iterator(it(), back), 17))
    _bit_equal(resumed, straight)


def test_async_save_stages_through_two_buffers(dev, tmp_path, monkeypatch):
    """save_async's host copy goes through two pinned buffers in turn: with
    buffers of 1 MiB + 3 bytes, a state holding many buffers' worth of
    complex, f64, f32 and integer tensors comes back bit for bit."""
    from ciao_tpu_torch import checkpoint
    from ciao_tpu_torch.solvers.saga import SAGAState

    monkeypatch.setattr(checkpoint, "_STAGE_BYTES", (1 << 20) + 3)
    gen = torch.Generator(device=dev).manual_seed(5)
    st = SAGAState(
        s=torch.randn(1_000_003, dtype=torch.complex64, generator=gen,
                      device=dev),
        gamma=torch.tensor(0.5, device=dev),
        av=torch.randn(777, generator=gen, device=dev),
        z=torch.randint(-9, 9, (3, 5), generator=gen, device=dev),
        seed=1, it=2, status=0,
        qcum=torch.rand(300_001, dtype=torch.float64, generator=gen,
                        device=dev))
    checkpoint.save_async(tmp_path / "st.pt", st).wait_until_finished()
    back = checkpoint.load(tmp_path / "st.pt", device=dev)
    for a, b in zip(back, st):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.device == b.device
            assert torch.equal(a, b)
        else:
            assert a == b


def test_load_onto_the_card_from_a_cpu_file(dev, tmp_path):
    """A state saved on the CPU loads onto cuda:0, every tensor there,
    and ``load_like`` follows a card template; by default ``load`` takes
    the card."""
    from ciao_tpu_torch import SAGA, NormL1, checkpoint
    from ciao_tpu_torch.solvers import loop, take

    gen = torch.Generator().manual_seed(4)
    A = torch.randn(512, 32, generator=gen)
    F = LeastSquaresRows(A, torch.randn(512, generator=gen), 512.0)
    L = ((A * A).sum(1) * 512).numpy()
    st = loop(take(iter(SAGA(block_sampling=True, batch=64).iterator(
        torch.zeros(32), F=F, g=NormL1(0.1), L=L)), 5))
    checkpoint.save(tmp_path / "cpu.pt", st)
    for back in (checkpoint.load(tmp_path / "cpu.pt", device=dev),
                 checkpoint.load(tmp_path / "cpu.pt")):
        for p, v in _fields(back):
            if isinstance(v, torch.Tensor):
                assert v.device == dev, p
        assert torch.equal(back.z.cpu(), st.z)
    like = checkpoint.load(tmp_path / "cpu.pt", device=dev)
    assert checkpoint.load_like(tmp_path / "cpu.pt", like).s.device == dev


def test_entry_launches_kernel_4_once(dev):
    """``entry()`` defaults to the card; its fn is one launch of kernel
    #4 (8 steps) and nothing else."""
    from ciao_tpu_torch.entry import entry

    fn, args = entry()
    assert args[2].z.device == dev
    names = ("saga_coeff_multistep_streamed", "saga_coeff_multistep",
             "coeff_apply_all")
    before = {k: getattr(tfb, k).launches for k in names}
    out = fn(*args)
    torch.cuda.synchronize()
    after = {k: getattr(tfb, k).launches - before[k] for k in names}
    assert after == {"saga_coeff_multistep_streamed": 1,
                     "saga_coeff_multistep": 0, "coeff_apply_all": 0}
    assert out.it == args[2].it + 8 and bool(torch.isfinite(out.z).all())


# ---------------------------------------------------------------------------
# the data-parallel path on the card (ciao_tpu_torch.parallel): one gloo
# rank in this process, CUDA tensors; each family's kernel path against
# its plain path (the same DP code with the gate closed)
# ---------------------------------------------------------------------------

DP_SMALL = dict(N=8_192, n=256, B=512)


def test_make_mesh_raises_without_a_group(dev):
    """No process group, no mesh: the ranks are the caller's to start."""
    import torch.distributed as dist

    from ciao_tpu_torch.parallel import make_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh()


def test_oracle_part_on_the_card_holds_only_its_rows(dev):
    """An oracle already on the rank's card: its part copies the rank's
    rows (the storage behind A holds n_loc rows), so the whole matrix
    can be freed."""
    from ciao_tpu_torch.parallel import shard_finite_sum
    from ciao_tpu_torch.parallel.mesh import Mesh

    N, n = DP_SMALL["N"], DP_SMALL["n"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    F = LeastSquaresRows(torch.randn(N, n, generator=gen, device=dev),
                         torch.randn(N, generator=gen, device=dev), float(N))
    part = shard_finite_sum(F, Mesh(group=None, rank=1, size=2, device=dev))
    n_loc = N // 2
    assert part.A.untyped_storage().nbytes() == n_loc * n * 4
    assert part.b.untyped_storage().nbytes() == n_loc * 4
    assert torch.equal(part.A, F.A[n_loc:])


@pytest.fixture(scope="module")
def dp_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import torch.distributed as dist

    from ciao_tpu_torch.parallel import make_mesh

    store = tmp_path_factory.mktemp("dp") / "store"
    dist.init_process_group("gloo", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    yield make_mesh()
    dist.destroy_process_group()


def test_make_mesh_defaults_to_the_card_and_raises_without_one(dp_mesh,
                                                               monkeypatch):
    """The mesh's device is the card of the local rank; with no card and
    no device named, make_mesh raises instead of running on the CPU."""
    from ciao_tpu_torch.parallel import make_mesh

    assert dp_mesh.device == torch.device("cuda", 0) and dp_mesh.size == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert make_mesh(device="cpu").device == torch.device("cpu")


def _dp_family(mesh, dev, family, seed=0):
    """(kernel path state, plain path state, the kernel path's launches,
    the plain path's) of a few rounds of ``family`` on the DP_SMALL Lasso
    (ProShI: its IndBox(-inf, 1) coupling)."""
    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.parallel import dp as tdp
    from ciao_tpu_torch.prox import IndBox, NormL1

    N, n, B = DP_SMALL["N"], DP_SMALL["n"], DP_SMALL["B"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    A = torch.randn(N, n, generator=gen, device=dev)
    F = parallel.shard_finite_sum(
        LeastSquaresRows(A, torch.randn(N, generator=gen, device=dev),
                         float(N)), mesh)
    L = (A * A).sum(1) * N
    g = (IndBox(-float("inf"), 1.0) if family == "proshi"
         else NormL1(0.1)).to(dev)
    x0 = torch.zeros(n, device=dev)
    base = dict(N=N, D=1, b_loc=B, alpha=0.999)
    gam_i = (0.999 * N / L).contiguous()
    gam_s = torch.tensor(1.0 / (3.0 * float(L.max())), device=dev)
    spec = {
        "saga": ("saga", dict(base, sweeping=1, block=True, coeff=True,
                              local_steps=16, rebase_every=2), gam_s, (), 3),
        "finito": ("finito_coeff", dict(base, sweeping=3, coeff=True,
                                        local_steps=16, rebase_every=2),
                   gam_i, (), 3),
        "lfinito": ("lfinito", dict(base, sweeping=3, local=True), gam_i,
                    (), 2),
        "svrg": ("svrg", dict(base, sweeping=1, block=True, local=True,
                              plus=False), gam_s / 3.3, (80,), 2),
        "svrg_plus": ("svrg", dict(base, sweeping=1, block=True, local=True,
                                   plus=True), gam_s / 3.3, (48,), 3),
        "proshi": ("proshi", dict(base, sweeping=2, local_steps=8,
                                  rebase_every=2), gam_i, (), 3),
        # local inner loops of 150 steps: launches of 128 and 22 an outer
        # step on #10/#11, the anchor or the bootstrap on #6
        "katyusha": ("katyusha", dict(base, sweeping=1, block=True,
                                      local=True, m_inner=150, variant="ns"),
                     L.max(), (0.5, 0.5), 3),
        "sarah": ("sarah", dict(base, sweeping=1, block=True, local=True,
                                m_inner=150), 1.0 / (2.0 * L.max()), (1.0,),
                  3),
    }[family]
    fam, cfg, gamma, extra, steps = spec
    out = []
    for fused in (True, False):
        c = dict(cfg, fused=fused)
        if fam in ("svrg", "katyusha", "sarah"):
            c["coeff"] = fused
        init, _, run, _ = parallel.build_dp_functions(fam, mesh, F, g,
                                                      tdp.DPCfg(**c))
        before = {k: getattr(tfb, k).launches for k in _DP_KERNELS}
        st = run(init(x0, gamma, 0, *extra), steps)
        torch.cuda.synchronize()
        out += [st, {k: getattr(tfb, k).launches - before[k]
                     for k in _DP_KERNELS}]
    return out


_DP_KERNELS = ("saga_coeff_multistep", "svrg_coeff_multistep",
               "coeff_apply_all", "lfinito_sweep_multistep",
               "finito_coeff_multistep", "proshi_multistep",
               "katyusha_coeff_multistep", "sarah_multistep")
_DP_LAUNCHED = {"saga": ("saga_coeff_multistep",),
                "finito": ("finito_coeff_multistep",),
                "lfinito": ("coeff_apply_all", "lfinito_sweep_multistep"),
                "svrg": ("svrg_coeff_multistep", "coeff_apply_all"),
                "svrg_plus": ("svrg_coeff_multistep", "coeff_apply_all"),
                "proshi": ("proshi_multistep",),
                "katyusha": ("katyusha_coeff_multistep", "coeff_apply_all"),
                "sarah": ("sarah_multistep", "coeff_apply_all")}


@pytest.mark.parametrize("family", list(_DP_LAUNCHED))
def test_dp_kernel_path_matches_plain_path(dp_mesh, dev, family):
    """Each DP family's kernel path (#3 SAGA rounds, #9 Finito rounds,
    #6 and #8 LFinito epochs, #5 and #6 SVRG and SVRG++ local inner
    loops, #18 ProShI rounds, #10 and #6 Katyusha and #11 and #6 SARAH
    local inner loops) on one gloo rank against the same DP code with the
    gate closed: the replicated vectors within 1e-6 of their largest
    entry, av and the tables within 1e-5; only the kernel path
    launches."""
    kst, kl, pst, pl = _dp_family(dp_mesh, dev, family)
    for k in _DP_LAUNCHED[family]:
        assert kl[k] > 0, (k, kl)
    assert not any(pl.values()), pl
    for f, v in kst._asdict().items():
        if not isinstance(v, torch.Tensor) or f == "gamma":
            continue
        w = getattr(pst, f)
        if w is None:  # the anchor coefficients: the kernel path's own
            continue
        tol = 1e-6 if f in ("z", "z_full", "w", "x", "x_tilde",
                            "y") else 1e-5
        err = float((v.double() - w.double()).abs().max()
                    / w.double().abs().max().clamp(min=1e-300))
        assert err <= tol, (family, f, err)


def test_deep_solve_pd_dp_certifies_on_the_card(dp_mesh, dev):
    """``deep_solve_pd_dp`` on one gloo rank, rows on the card: the
    planted fused lasso certifies with rel ≤ 1e-8 against the exact f64
    optimum, flat runs exact, as the single card's deep_solve_pd does;
    no kernel wrapper launches (the route has none)."""
    import numpy as np

    from ciao_tpu_torch import FirstDifference, NormL1
    from ciao_tpu_torch.parallel import deep_solve_pd_dp

    p, F = _fused_lasso(dev)
    wrappers = [f for f in vars(tfb).values()
                if callable(f) and hasattr(f, "launches")]
    before = [f.launches for f in wrappers]
    x, info = deep_solve_pd_dp(torch.zeros(256, device=dev), F,
                               h=NormL1(torch.tensor(p.lam)),
                               K=FirstDifference(), N=8_192, mesh=dp_mesh,
                               chunk_steps=512, max_steps=16_384,
                               polish_chunk=1_024)
    assert x.device.type == "cuda"
    assert info.refined and info.certified
    xn = x.double().cpu().numpy()
    rel = (p.cost(xn) - p.f_star) / abs(p.f_star)
    assert 0 <= rel <= 1e-8
    true_J = np.abs(np.diff(p.x_star)) > 0
    assert np.all(np.diff(xn)[~true_J] == 0.0)
    assert [f.launches for f in wrappers] == before
