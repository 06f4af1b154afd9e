"""Packaged model families (``get(name)``, ``available()``)."""
from .base import ModelDef, available, get, register  # noqa: F401
from .infection import one_i, two_i, zero_i  # noqa: F401

__all__ = ["ModelDef", "available", "get", "register",
           "zero_i", "one_i", "two_i"]
