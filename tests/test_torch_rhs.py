"""RHS front end (odelib_tpu_torch/rhs.py): the traced DAG's torch
evaluator against the plain RHS for the three RHS styles, golden text of
the emitted CUDA source, and the error for an RHS that does not trace."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odelib_tpu.models import infection as jax_infection
from odelib_tpu_torch.model import make_spec
from odelib_tpu_torch.ops import build
from odelib_tpu_torch.ops.cuda_mh import survey_fused
from odelib_tpu_torch.rhs import RhsTraceError, adapt_rhs, trace_rhs

from helpers import one_i, synthetic_df, zero_i, zero_i_refstyle

_CASES = [  # (fn, style, S, P)
    (zero_i, "jax", 2, 3),                  # jnp.stack, S, V = y
    (zero_i_refstyle, "reference", 2, 3),   # np.array, f(y, t, ps)
    (one_i, "jax", 3, 4),
    (jax_infection._zero_i, "jax", 2, 3),
    (jax_infection._one_i, "jax", 3, 4),
    (jax_infection._two_i, "jax", 4, 5),
]


@pytest.mark.parametrize("fn,style,S,P", _CASES,
                         ids=[f"{c[0].__module__}.{c[0].__name__}"
                              for c in _CASES])
def test_dag_evaluator_matches_plain_rhs(fn, style, S, P):
    rng = np.random.default_rng(1)
    y = (rng.uniform(1e5, 1e7, (S, 64))).astype(np.float32)
    ps = (np.array([0.6, 2.4e-8, 24.0, 3.0, 2.0][:P])[:, None]
          * np.exp(rng.normal(0, 0.3, (P, 64)))).astype(np.float32)
    # the plain RHS as its own package runs it (jnp / numpy, float32)
    if style == "reference":
        ref = np.asarray(fn(y, 0.0, list(ps)))
    else:
        ref = np.asarray(fn(0.0, jnp.asarray(y), [jnp.asarray(p) for p in ps]))
    prog = trace_rhs(adapt_rhs(fn, style), S, P)
    got = prog.evaluate(0.0, list(torch.as_tensor(y)),
                        list(torch.as_tensor(ps)))
    got = torch.stack(got).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    # the adapted RHS also runs eagerly on tensors (rebound np/jnp)
    eager = adapt_rhs(fn, style)(0.0, torch.as_tensor(y),
                                 list(torch.as_tensor(ps)))
    np.testing.assert_array_equal(torch.as_tensor(eager).numpy(), got)


_GOLDEN_ZERO_I = """\
// traced from zero_i
#define ODE_S 2
#define ODE_P 3
__device__ __forceinline__ void rhs(float t, const float* y, const float* p, float* dy) {
  (void)t; (void)y; (void)p;
  const float v0 = p[0] * y[0];
  const float v1 = p[1] * y[0];
  const float v2 = v1 * y[1];
  const float v3 = v0 - v2;
  const float v4 = p[2] * p[1];
  const float v5 = v4 * y[0];
  const float v6 = v5 * y[1];
  const float v7 = v6 - v2;
  dy[0] = v3;
  dy[1] = v7;
}
"""


def test_cuda_source_golden_zero_i():
    """Python's evaluation order, structural CSE (phi*S*V once)."""
    prog = trace_rhs(adapt_rhs(zero_i, "jax"), 2, 3)
    assert prog.cuda_source() == _GOLDEN_ZERO_I
    header = build.generated_header(prog)
    assert "#define ODELIB_TWO_PI 6.2831855f" in header
    assert "step_dopri5" in header and "step_rk4" in header


def test_constants_rounded_to_f32_and_int_powers():
    def f(t, y, ps):
        S, V = y
        return [0.1 * S ** 2 - 2.0 * 3.0 * V, S ** -1 + np.exp(-t)]
    prog = trace_rhs(adapt_rhs(f, "jax"), 2, 0)
    src = prog.cuda_source()
    assert "0.1f" in src and "6.0f" in src and "expf(" in src
    y = [torch.tensor([3.0, 5.0]), torch.tensor([7.0, 11.0])]
    got = prog.evaluate(0.5, y, [])
    S, V = (v.numpy() for v in y)
    np.testing.assert_array_equal(
        got[0].numpy(), np.float32(0.1) * (S * S) - np.float32(6.0) * V)
    np.testing.assert_allclose(
        got[1].numpy(), 1.0 / S + np.exp(np.float32(-0.5)), rtol=1e-7)


def _branchy(t, y, ps):
    mu, phi, beta = ps
    S, V = y
    if t < 10.0:     # Python control flow: eager-only
        mu = mu * 1.0
    return jnp.stack([mu * S - phi * S * V, beta * phi * S * V - phi * S * V])


def _dotty(t, y, ps):
    return np.dot(np.array(ps[:2]), y)


@pytest.mark.parametrize("fn,msg", [
    (_branchy, "Python control flow"),
    (_dotty, "np.dot is not supported"),
])
def test_untraceable_rhs_names_the_construct(fn, msg):
    with pytest.raises(RhsTraceError, match=msg):
        trace_rhs(adapt_rhs(fn, "jax"), 2, 3)


def test_untraceable_rhs_runs_eagerly_on_cpu():
    """The CPU twin falls back to eager torch for an RHS that does not
    trace (the CUDA wrappers refuse it instead); results equal the traced
    twin of the same model."""
    from odelib_tpu_torch.data import (build_obsdata_host,
                                       compact_observation_grid,
                                       format_dataframe)
    df = format_dataframe(synthetic_df(), ("S", "V"))
    times = np.linspace(0, 3.1, 64)
    spec_b = make_spec(adapt_rhs(_branchy), ("mu", "phi", "beta"), ("S", "V"))
    spec_z = make_spec(adapt_rhs(zero_i), ("mu", "phi", "beta"), ("S", "V"))
    obs, _ = build_obsdata_host(df, times, spec_z.post_snames)
    tf, obs = compact_observation_grid(obs, times)
    y0 = np.array([5.2e6, 1.1e7])
    th = torch.tensor([[0.6, 2.4e-8, 24.0], [0.5, 2e-8, 20.0]])
    a = survey_fused(spec_b, obs, tf, y0, th, substeps=1)
    b = survey_fused(spec_z, obs, tf, y0, th, substeps=1)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_generated_header_per_set_of_models():
    """One library per set of distinct RHS programs: experiments of one
    model (two adapted copies of zero_i) share the single-model header; a
    second model adds a ModelN type and ODE_MODELS; a diffusion appears
    only in an SDE model's header."""
    z1 = make_spec(adapt_rhs(zero_i), ("mu", "phi", "beta"), ("S", "V"))
    z2 = make_spec(adapt_rhs(zero_i), ("mu", "phi", "beta"), ("S", "V"))
    o = make_spec(adapt_rhs(one_i), ("mu", "phi", "beta", "lam"),
                  ("S", "I1", "V"))
    progs, model_of = build.distinct_programs([z1, z2, o, z1])
    assert model_of == [0, 0, 1, 0] and len(progs) == 2
    single = build.generated_header(trace_rhs(z1.rhs, 2, 3))
    same, _ = build.distinct_programs([z1, z2])
    assert build.generated_header(same[0], None, tuple(same[1:])) == single
    assert "diffusion" not in single and "ODE_MODELS" not in single
    joint = build.generated_header(progs[0], None, tuple(progs[1:]))
    assert joint.startswith(single)
    assert "struct Model1" in joint and "namespace odelib_m1" in joint
    assert "#define ODE_MODELS(X) X(0) X(1)" in joint
    assert "#define ODE_PMAX 4" in joint
    sde = make_spec(adapt_rhs(zero_i), ("mu", "phi", "beta"), ("S", "V"),
                    diffusion=adapt_rhs(lambda t, y, ps: [0.3 * y[0],
                                                          0.1 * y[1]]))
    header = build.generated_header(trace_rhs(sde.rhs, 2, 3),
                                    trace_rhs(sde.diffusion, 2, 3))
    assert header.startswith(single) and "#define ODE_HAS_DIFFUSION" in header
    assert "void diffusion(float t" in header and "0.3f * y[0]" in header
