"""Samplers: Latin-hypercube draws and the MH record structure."""
from .lhs import lhs_unit, sample_lhs
from .mh import MHOutput, survey

__all__ = ["lhs_unit", "sample_lhs", "MHOutput", "survey"]
