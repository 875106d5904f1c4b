"""Problem generators of the port."""

from ciao_tpu_torch.utils.problems import (
    LassoProblem, PlantedSharingProblem, SharingProblem, make_lasso,
    make_sharing, make_sharing_planted,
)

__all__ = ["LassoProblem", "make_lasso", "SharingProblem", "make_sharing",
           "PlantedSharingProblem", "make_sharing_planted"]
