"""Samplers: Latin-hypercube draws, the MH record structure, the batched
and joint surveys and the tempering bookkeeping."""
from .joint import joint_survey
from .lhs import lhs_unit, sample_lhs
from .mh import MHOutput, survey
from .pt import swap_attempts

__all__ = ["lhs_unit", "sample_lhs", "MHOutput", "survey", "joint_survey",
           "swap_attempts"]
