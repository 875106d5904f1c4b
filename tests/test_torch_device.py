"""Where the port's entry points run when the caller names no device: the
card when there is one, else the CPU (``runtime.default_device``)."""

import numpy as np
import pytest
import torch

from ciao_tpu_torch import runtime
from ciao_tpu_torch.convert import tensor_from_numpy
from ciao_tpu_torch.oracles import LeastSquaresRows
from ciao_tpu_torch.prox import NormL1
from ciao_tpu_torch.solvers import SAGA, SVRG, ForwardBackward
from ciao_tpu_torch.solvers.base import facade_device
from ciao_tpu_torch.utils.problems import make_lasso
from torch_threads import one_torch_thread  # noqa: F401


def test_entry_points_default_to_the_card(monkeypatch):
    """With a card present, the facades and ``convert`` run on cuda:0
    when the caller names no device and passes no tensor: here the CPU
    build of torch then refuses to make the tensor, which shows where it
    was headed; a CPU tensor or ``device="cpu"`` keeps the CPU. Without a
    card everything defaults to the CPU."""
    prob = make_lasso(N=6, n=3, p=2, seed=0, dtype=np.float32)
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b), 6.0)
    g = NormL1(prob.lam)
    assert runtime.default_device() == torch.device("cpu")
    assert facade_device(None, [0.0]) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda0 = torch.device("cuda", 0)
    assert runtime.default_device() == cuda0
    assert facade_device(None, [0.0, 0.0, 0.0]) == cuda0
    assert facade_device(None, torch.zeros(3)) == torch.device("cpu")
    assert facade_device("cpu", [0.0]) == torch.device("cpu")
    for solver in (SAGA(maxit=2), SVRG(maxit=2, gamma=0.01),
                   ForwardBackward(maxit=2)):
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            solver([0.0, 0.0, 0.0], F=F, g=g, L=prob.L, N=6)
        x, _ = solver(torch.zeros(3), F=F, g=g, L=prob.L, N=6)
        assert x.device.type == "cpu"
        x, _ = type(solver)(**{**solver.__dict__, "device": "cpu"})(
            [0.0, 0.0, 0.0], F=F, g=g, L=prob.L, N=6)
        assert x.device.type == "cpu"
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        tensor_from_numpy(np.zeros(3))
    assert tensor_from_numpy(np.zeros(3), device="cpu").device.type == "cpu"
