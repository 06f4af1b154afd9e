"""The ecology, epidemiology and neuroscience families: the port's
registry entries, names, defaults, summations and priors against
``odelib_tpu.models``, and each RHS (run eagerly and through its traced
DAG, as the kernels take it) against the JAX package's in float64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odelib_tpu import models as jm
from odelib_tpu_torch import models as tm
from odelib_tpu_torch.rhs import adapt_rhs, trace_rhs

FAMILIES = ("lotka_volterra", "logistic", "chemostat", "sir", "seir",
            "fitzhugh_nagumo", "hindmarsh_rose")


def test_registry_holds_every_family():
    assert set(FAMILIES) <= set(tm.available())
    assert set(tm.available()) == set(jm.available())
    for name in FAMILIES:
        assert getattr(tm, name) is tm.get(name)
        assert name in tm.__all__


@pytest.mark.parametrize("name", FAMILIES)
def test_definitions_match_odelib_tpu(name):
    """Names, defaults, horizon, stiffness, summations and default priors
    (the same family and log density, None where the JAX package fixes
    the parameter) equal the JAX package's."""
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


@pytest.mark.parametrize("name", FAMILIES)
def test_rhs_values_match_odelib_tpu(name):
    """Eager and traced RHS against the JAX package's, float64, on 32
    lanes around the defaults (states of either sign kept: the
    neuroscience models' change sign): within 1e-13 relative."""
    t, j = tm.get(name), jm.get(name)
    rng = np.random.default_rng(1)
    S, P = len(t.snames), len(t.pnames)
    y0 = np.where(np.abs(t.y0()) > 0.1, t.y0(), 0.5)
    y = y0[:, None] * np.exp(rng.normal(0, 0.3, (S, 32)))
    p = t.theta()[:, None] * np.exp(rng.normal(0, 0.2, (P, 32)))
    ref = np.asarray(jnp.stack(list(j.rhs(0.0, jnp.asarray(y),
                                          list(jnp.asarray(p))))))
    eager = torch.stack(list(t.rhs(0.0, torch.as_tensor(y),
                                   list(torch.as_tensor(p))))).numpy()
    prog = trace_rhs(adapt_rhs(t.rhs, "jax"), S, P)
    traced = torch.stack(prog.evaluate(
        0.0, list(torch.as_tensor(y)), list(torch.as_tensor(p)))).numpy()
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(eager, ref, rtol=1e-13, atol=1e-300)
    np.testing.assert_allclose(traced, ref, rtol=1e-13, atol=1e-300)
    assert "rhs(" in prog.cuda_function("rhs", ())
