"""Problem generators of the port."""

from ciao_tpu_torch.utils.problems import LassoProblem, make_lasso

__all__ = ["LassoProblem", "make_lasso"]
