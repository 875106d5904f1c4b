"""2-D total-variation denoising, isotropic (ROF) and anisotropic, with
Chambolle-Pock on one card.

The port of ``examples/tv_denoise_2d.py``. The quadratic data term is the
prox'd g (``SqrDistPoint``); the TV lives in the dual through a stencil
linear map. Isotropic TV pairs the horizontal and vertical difference
fields pixelwise under ``GroupNormL21``; anisotropic stacks them under a
plain ℓ1. No kernel lies on this route (no F: the steps are the proxes
and the stencil).

    python examples_torch/tv_denoise_2d.py          # 512 x 512
    python examples_torch/tv_denoise_2d.py small    # smoke shape
    python examples_torch/tv_denoise_2d.py small cpu

The phantom and its noise are the JAX example's (numpy, seed 0).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import ciao_tpu_torch
from ciao_tpu_torch import (
    FirstDifference2D, GradientMap2D, GroupNormL21, NormL1, runtime,
)
from ciao_tpu_torch.prox import SqrDistPoint


def main(H=512, W=512, lam=0.3, maxit=4000, small=False, device=None):
    dev = runtime.entry_device(device)
    if small:  # smoke shapes (tests/test_torch_examples.py)
        H, W, maxit = 32, 32, 2000
    n = H * W
    rng = np.random.default_rng(0)
    truth = np.zeros((H, W), np.float32)
    truth[: H // 2, :] = 1.5
    truth[H // 2:, W // 2:] = -1.0
    noisy = truth + 0.25 * rng.standard_normal((H, W)).astype(np.float32)
    b = torch.tensor(noisy.reshape(-1), device=dev)
    g = SqrDistPoint(b, 1.0)

    results = {}
    for tag, K, h in (
        ("isotropic", GradientMap2D(H=H, W=W), GroupNormL21(lam, groups=2)),
        ("anisotropic", FirstDifference2D(H=H, W=W), NormL1(lam)),
    ):
        x, _ = ciao_tpu_torch.ChambollePock(maxit=maxit)(
            torch.zeros(n, device=dev), g=g, h=h, K=K, N=1)
        img = x.cpu().numpy().reshape(H, W)
        err = np.linalg.norm(img - truth) / np.linalg.norm(truth)
        noise_err = np.linalg.norm(noisy - truth) / np.linalg.norm(truth)
        print(f"{tag:11s}: rel error {err:.3f} (noisy input {noise_err:.3f})")
        assert err < noise_err          # it denoised
        results[tag] = img
    # both models recover the blocky structure; the axis-aligned edges
    # of this phantom favor neither, so they agree closely
    gap = np.max(np.abs(results["isotropic"] - results["anisotropic"]))
    print(f"iso-vs-aniso max pixel gap: {gap:.3f}")
    return results


if __name__ == "__main__":
    main(small="small" in sys.argv[1:],
         device="cpu" if "cpu" in sys.argv[1:] else None)
