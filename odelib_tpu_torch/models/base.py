"""Packaged model families: an RHS plus canonical names, defaults and
priors. Counterpart of ``odelib_tpu/models/base.py``."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..model import ModelSpec, make_spec


@dataclasses.dataclass(frozen=True)
class ModelDef:
    """A packaged ODE model family member (see ``odelib_tpu``'s
    ``ModelDef``): ``rhs(t, y, ps)`` with elementwise operations only,
    canonical parameter/state orderings, literature defaults and a
    factory of default priors. ``stiff`` models default to the implicit
    solvers (:attr:`recommended_method`, :attr:`recommended_fixed_stepper`,
    and ``method='kvaerno5'`` in :meth:`framework`)."""
    name: str
    rhs: Callable
    pnames: Tuple[str, ...]
    snames: Tuple[str, ...]
    default_theta: Tuple[float, ...]
    default_y0: Tuple[float, ...]
    default_t_end: float
    priors: Optional[Callable[[], Dict[str, object]]] = None
    state_summations: Optional[dict] = None
    stiff: bool = False
    doc: str = ""

    def spec(self, state_summations: Optional[dict] = "default") -> ModelSpec:
        from ..rhs import adapt_rhs
        ss = (self.state_summations if state_summations == "default"
              else state_summations)
        return make_spec(adapt_rhs(self.rhs, "jax"), self.pnames,
                         self.snames, state_summations=ss)

    def theta(self) -> np.ndarray:
        return np.asarray(self.default_theta, float)

    def y0(self) -> np.ndarray:
        return np.asarray(self.default_y0, float)

    def times(self, n: int = 200) -> np.ndarray:
        return np.linspace(0.0, self.default_t_end, n)

    @property
    def recommended_method(self) -> str:
        """Adaptive solver matched to the model's stiffness."""
        return "kvaerno5" if self.stiff else "dopri5"

    @property
    def recommended_fixed_stepper(self) -> str:
        """Fixed stepper of the fused kernels."""
        return "kvaerno3" if self.stiff else "dopri5"

    def framework(self, dataframe, *, use_default_priors: bool = True,
                  random_seed: int = 0, **kwargs):
        """A ready :class:`odelib_tpu_torch.ModelFramework` fitting this
        model to ``dataframe`` (a stiff model's solver defaults to
        ``method='kvaerno5'``)."""
        from ..api import ModelFramework, parameter

        kw = dict(kwargs)
        if use_default_priors and self.priors is not None:
            for pname, d in self.priors().items():
                if pname not in kw and d is not None:
                    kw[pname] = parameter(stats_gen=d, name=pname,
                                          random_seed=random_seed)
        for pname, v in zip(self.pnames, self.default_theta):
            kw.setdefault(pname, float(v))
        kw.setdefault("state_summations", self.state_summations)
        if self.stiff:
            kw.setdefault("method", "kvaerno5")
        return ModelFramework(ODE=self.rhs, parameter_names=list(self.pnames),
                              state_names=list(self.snames),
                              dataframe=dataframe, random_seed=random_seed,
                              ode_style="jax", **kw)


_REGISTRY: Dict[str, ModelDef] = {}


def register(model: ModelDef) -> ModelDef:
    if model.name in _REGISTRY:
        raise ValueError(f"model {model.name!r} already registered")
    _REGISTRY[model.name] = model
    return model


def get(name: str) -> ModelDef:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{sorted(_REGISTRY)}") from None


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
