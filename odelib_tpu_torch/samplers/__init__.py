"""Samplers: Latin-hypercube draws, the MH record structure and the
tempering bookkeeping."""
from .lhs import lhs_unit, sample_lhs
from .mh import MHOutput, survey
from .pt import swap_attempts

__all__ = ["lhs_unit", "sample_lhs", "MHOutput", "survey", "swap_attempts"]
