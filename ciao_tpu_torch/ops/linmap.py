"""Linear maps K of the primal-dual composite term h(Kx).

Counterpart of ``ciao_tpu/ops/linmap.py``. A map is a small ``nn.Module``
(a dense map's matrix is a buffer, so ``.to(device)`` moves it) with

  * ``matvec(x) -> Kx``        ((m,) from (n,))
  * ``rmatvec(y) -> Kᴴy``      (the adjoint; conjugate transpose for
                                complex dtypes)
  * ``out_dim(n) -> m``
  * ``opnorm_bound(n) -> float`` — an upper bound on ‖K‖₂ (the default
    stepsizes; an underestimate would break convergence).

No TPU kernel serves them: the stencils are a few elementwise tensor
operations, and ``DenseMap``'s products are ``torch.matmul``, as JAX
leaves them to XLA outside any kernel.
"""

from __future__ import annotations

import torch
from torch import nn

_SQRT8 = 2.8284271247461903  # the √8 bound of the 2-D difference pairs


class IdentityMap(nn.Module):
    """K = I: primal-dual degenerates to the plain composite form."""

    def matvec(self, x):
        return x

    def rmatvec(self, y):
        return y

    def out_dim(self, n):
        return n

    def opnorm_bound(self, n):
        return 1.0


class DenseMap(nn.Module):
    """K given as an explicit (m, n) matrix ``M``."""

    def __init__(self, M):
        super().__init__()
        self.register_buffer("M", torch.as_tensor(M))

    def _promoted(self, v):
        # JAX's promotion: real rows meet a complex vector as complex
        dt = torch.promote_types(self.M.dtype, v.dtype)
        return self.M.to(dt), v.to(dt)

    def matvec(self, x):
        M, x = self._promoted(x)
        return M @ x

    def rmatvec(self, y):
        M, y = self._promoted(y)
        return M.conj().T @ y

    def out_dim(self, n):
        return self.M.shape[0]

    def opnorm_bound(self, n):
        # the exact spectral norm, once at setup (the stepsizes are fixed)
        return float(torch.linalg.matrix_norm(self.M, ord=2))


def _check_image(n, H, W):
    if n != H * W:
        raise ValueError(f"an (H, W) = ({H}, {W}) map takes n = {H * W}, "
                         f"not {n}")


class FirstDifference(nn.Module):
    """K = D, (Dx)_i = x_{i+1} − x_i, shape (n − 1, n): ‖Dx‖₁ is 1-D total
    variation. The adjoint is the negative divergence."""

    def matvec(self, x):
        return x[1:] - x[:-1]

    def rmatvec(self, y):
        # (Dᵀy)_0 = −y_0, (Dᵀy)_i = y_{i−1} − y_i, (Dᵀy)_{n−1} = y_{n−2}
        return torch.cat([-y[:1], y[:-1] - y[1:], y[-1:]])

    def out_dim(self, n):
        return n - 1

    def opnorm_bound(self, n):
        return 2.0  # ‖D‖ = 2·sin(π(n−1)/(2n)) < 2


class FirstDifference2D(nn.Module):
    """K = [D_h; D_v] on an (H, W) image flattened row-major: the stacked
    horizontal and vertical first differences, horizontal block first
    ((H·(W−1) + (H−1)·W,) out), so ‖Kx‖₁ is anisotropic 2-D total
    variation. ‖K‖² ≤ 8."""

    def __init__(self, H: int, W: int):
        super().__init__()
        self.H, self.W = int(H), int(W)

    def matvec(self, x):
        im = x.reshape(self.H, self.W)
        dh = (im[:, 1:] - im[:, :-1]).reshape(-1)
        dv = (im[1:, :] - im[:-1, :]).reshape(-1)
        return torch.cat([dh, dv])

    def rmatvec(self, y):
        H, W = self.H, self.W
        mh = H * (W - 1)
        dh = y[:mh].reshape(H, W - 1)
        dv = y[mh:].reshape(H - 1, W)
        im = torch.zeros((H, W), dtype=y.dtype, device=y.device)
        im[:, :-1] -= dh
        im[:, 1:] += dh
        im[:-1, :] -= dv
        im[1:, :] += dv
        return im.reshape(-1)

    def out_dim(self, n):
        _check_image(n, self.H, self.W)
        return self.H * (self.W - 1) + (self.H - 1) * self.W

    def opnorm_bound(self, n):
        return _SQRT8


class GradientMap2D(nn.Module):
    """K = (∇_h, ∇_v) on an (H, W) image flattened row-major: forward
    differences with the Neumann boundary (the last column or row of each
    field is 0), (2·H·W,) out, horizontal field first. Paired pixelwise
    under ``GroupNormL21`` it is isotropic total variation. ‖K‖² ≤ 8."""

    def __init__(self, H: int, W: int):
        super().__init__()
        self.H, self.W = int(H), int(W)

    def matvec(self, x):
        im = x.reshape(self.H, self.W)
        dh = torch.zeros_like(im)
        dh[:, :-1] = im[:, 1:] - im[:, :-1]
        dv = torch.zeros_like(im)
        dv[:-1, :] = im[1:, :] - im[:-1, :]
        return torch.cat([dh.reshape(-1), dv.reshape(-1)])

    def rmatvec(self, y):
        H, W = self.H, self.W
        dh = y[:H * W].reshape(H, W)
        dv = y[H * W:].reshape(H, W)
        im = torch.zeros((H, W), dtype=y.dtype, device=y.device)
        im[:, :-1] -= dh[:, :-1]
        im[:, 1:] += dh[:, :-1]
        im[:-1, :] -= dv[:-1, :]
        im[1:, :] += dv[:-1, :]
        return im.reshape(-1)

    def out_dim(self, n):
        _check_image(n, self.H, self.W)
        return 2 * self.H * self.W

    def opnorm_bound(self, n):
        return _SQRT8
