"""Problem generators of the port."""

from ciao_tpu_torch.utils.problems import (
    LassoProblem, LogisticProblem, PlantedSharingProblem, SharingProblem,
    make_lasso, make_logistic_l1, make_sharing, make_sharing_planted,
)

__all__ = ["LassoProblem", "make_lasso", "LogisticProblem",
           "make_logistic_l1", "SharingProblem", "make_sharing",
           "PlantedSharingProblem", "make_sharing_planted"]
