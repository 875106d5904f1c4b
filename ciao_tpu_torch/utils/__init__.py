"""Problem generators of the port."""

from ciao_tpu_torch.utils.problems import (
    LassoProblem, LogisticProblem, PlantedFusedLassoProblem,
    PlantedSharingProblem, PlantedThreeTermProblem, SharingProblem,
    SparseLassoProblem, make_fused_lasso_planted, make_lasso,
    make_logistic_l1, make_sharing, make_sharing_planted,
    make_sparse_lasso_ell, make_three_term_planted,
)

__all__ = ["LassoProblem", "make_lasso", "LogisticProblem",
           "make_logistic_l1", "SharingProblem", "make_sharing",
           "PlantedSharingProblem", "make_sharing_planted",
           "SparseLassoProblem", "make_sparse_lasso_ell",
           "PlantedFusedLassoProblem", "make_fused_lasso_planted",
           "PlantedThreeTermProblem", "make_three_term_planted"]
