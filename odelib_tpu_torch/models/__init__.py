"""Packaged model families (``get(name)``, ``available()``)."""
from .base import ModelDef, available, get, register  # noqa: F401
from .chemistry import oregonator, robertson, vanderpol  # noqa: F401
from .ecology import chemostat, logistic, lotka_volterra  # noqa: F401
from .epidemiology import seir, sir  # noqa: F401
from .infection import one_i, two_i, zero_i  # noqa: F401
from .neuroscience import fitzhugh_nagumo, hindmarsh_rose  # noqa: F401
from .pharmacology import pk_oral, pk_two_compartment  # noqa: F401

__all__ = ["ModelDef", "available", "get", "register",
           "zero_i", "one_i", "two_i",
           "lotka_volterra", "logistic", "chemostat",
           "sir", "seir",
           "robertson", "vanderpol", "oregonator",
           "pk_oral", "pk_two_compartment",
           "fitzhugh_nagumo", "hindmarsh_rose"]
