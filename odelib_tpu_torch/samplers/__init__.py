"""Samplers: Latin-hypercube draws, the batched and joint surveys, and the
reference's XLA scan samplers in torch (MH, its checkpointed run, the
Goodman-Weare ensemble, parallel tempering with its checkpointed run and
``tune_ladder``), with the record structure and the tempering
bookkeeping."""
from .ensemble import ensemble_mh
from .joint import joint_survey
from .lhs import lhs_unit, sample_lhs
from .mh import (MHOutput, metropolis_hastings,
                 metropolis_hastings_checkpointed, survey)
from .pt import (parallel_tempering, parallel_tempering_checkpointed,
                 swap_attempts, tune_ladder)

__all__ = ["lhs_unit", "sample_lhs", "MHOutput", "survey", "joint_survey",
           "metropolis_hastings", "metropolis_hastings_checkpointed",
           "ensemble_mh", "parallel_tempering",
           "parallel_tempering_checkpointed", "tune_ladder",
           "swap_attempts"]
