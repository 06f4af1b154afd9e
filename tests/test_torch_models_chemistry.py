"""The stiff chemistry family and the model definitions' stiffness
routing: the port's registry entries, defaults, priors and RHS values
against ``odelib_tpu.models``, ``recommended_method`` and
``recommended_fixed_stepper`` (tests/test_models.py's counterpart), and
the stiff ``framework()`` default ``method='kvaerno5'``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odelib_tpu import models as jm
from odelib_tpu_torch import models as tm
from odelib_tpu_torch.rhs import adapt_rhs, trace_rhs

from scoring_cases import robertson_frame

CHEMISTRY = ("robertson", "vanderpol", "oregonator")


def test_registry_holds_the_chemistry_family():
    assert set(CHEMISTRY) <= set(tm.available())
    assert set(tm.available()) <= set(jm.available())
    for name in CHEMISTRY:
        assert getattr(tm, name) is tm.get(name)
    with pytest.raises(KeyError, match="unknown model"):
        tm.get("brusselator")


@pytest.mark.parametrize("name", CHEMISTRY)
def test_definitions_match_odelib_tpu(name):
    """Names, defaults, horizon, stiffness and default priors (the same
    family and parameters, where the JAX package sets one) equal the JAX
    package's."""
    t, j = tm.get(name), jm.get(name)
    for field in ("pnames", "snames", "default_theta", "default_y0",
                  "default_t_end", "stiff", "state_summations"):
        assert getattr(t, field) == getattr(j, field), field
    tp, jp = t.priors(), j.priors()
    assert set(tp) == set(jp)
    for p in tp:
        if jp[p] is None:
            assert tp[p] is None
            continue
        assert type(tp[p]).__name__ == type(jp[p]).__name__
        x = np.array([0.5, 1.0, 2.0]) * t.default_theta[t.pnames.index(p)]
        np.testing.assert_allclose(
            tp[p].logpdf(torch.as_tensor(x)).numpy(),
            np.asarray(jp[p].logpdf(jnp.asarray(x))), rtol=1e-12)


@pytest.mark.parametrize("name", CHEMISTRY)
def test_rhs_values_match_odelib_tpu(name):
    """The torch RHS run eagerly and through its traced DAG against the
    JAX package's, float64, on 32 lanes around the defaults: within
    1e-13 relative."""
    t, j = tm.get(name), jm.get(name)
    rng = np.random.default_rng(0)
    S, P = len(t.snames), len(t.pnames)
    y = (np.maximum(np.abs(t.y0()), 0.1)[:, None]
         * np.exp(rng.normal(0, 0.3, (S, 32))))
    p = t.theta()[:, None] * np.exp(rng.normal(0, 0.2, (P, 32)))
    ref = np.asarray(jnp.stack(list(j.rhs(0.0, jnp.asarray(y),
                                          list(jnp.asarray(p))))))
    eager = torch.stack(list(t.rhs(0.0, torch.as_tensor(y),
                                   list(torch.as_tensor(p))))).numpy()
    traced = torch.stack(trace_rhs(adapt_rhs(t.rhs, "jax"), S, P).evaluate(
        0.0, list(torch.as_tensor(y)), list(torch.as_tensor(p)))).numpy()
    np.testing.assert_allclose(eager, ref, rtol=1e-13)
    np.testing.assert_allclose(traced, ref, rtol=1e-13)


def test_stiff_flags_route_to_implicit():
    for name in tm.available():
        m, j = tm.get(name), jm.get(name)
        assert m.recommended_method == j.recommended_method
        assert m.recommended_fixed_stepper == j.recommended_fixed_stepper
        stiff = name in CHEMISTRY
        assert m.stiff == stiff
        assert m.recommended_method == ("kvaerno5" if stiff else "dopri5")
        assert m.recommended_fixed_stepper == ("kvaerno3" if stiff
                                               else "dopri5")


def test_stiff_framework_defaults_to_kvaerno5():
    """A stiff model's framework solves with Kvaerno5 unless told
    otherwise; a non-stiff one keeps Dopri5; the Robertson fit's
    integrate() runs the adaptive Kvaerno5 (finite, y1 + y2 + y3
    conserved)."""
    df = robertson_frame()
    fw = tm.robertson.framework(df, t_steps=33, device="cpu")
    assert fw._solver["method"] == "kvaerno5"
    assert tm.robertson.framework(df, t_steps=33, device="cpu",
                                  method="kvaerno3")._solver["method"] \
        == "kvaerno3"
    ys = fw.integrate(as_dataframe=False)
    assert np.isfinite(ys).all()
    np.testing.assert_allclose(ys.sum(axis=1), ys[0].sum(), rtol=1e-6)
    assert tm.zero_i.framework(None, device="cpu")._solver["method"] \
        == "dopri5"
