"""MH on a model of more than 32 states: the port's twin against
``odelib_tpu``'s Pallas kernel in interpret mode on two_i with 31 latent
classes (33 states, the host observable summing 32 of them: a member mask
of two words), on the demo data's first three sampling times thinned by
2. MH's tolerances
(tests/test_torch_mh.py): accept sequences equal, theta and R^2 within
1e-5, chi within 5e-5."""
import numpy as np
import pytest

from odelib_tpu.ops import pallas_mh as J
from odelib_tpu_torch.ops import cuda_mh as T

from test_torch_states import _draws, _jax_case


@pytest.fixture(scope="module")
def chain33():
    return _jax_case(31)


def test_mh_twin_on_33_states_matches_pallas_interpret(chain33):
    """A short MH run: equal accept sequences, theta and R^2 within 1e-5,
    chi within 5e-5."""
    spec, tspec, obs, tf, y0 = chain33
    th0 = _draws(31, 32, 0.05, seed=3)
    kw = dict(nits=10, burnin=4, substeps=4, rwalk_std=0.02)
    ref = J.metropolis_hastings_fused(spec, obs, tf, y0, th0, seed=7,
                                      tile_chains=128, interpret=True, **kw)
    obs_t, th_t, seed, y0_t = T.inputs_from_reference(obs, th0, 7, y0)
    got = T.metropolis_hastings_fused(tspec, obs_t, tf, y0_t, th_t, seed,
                                      **kw)
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-5)
    np.testing.assert_allclose(got.rsquared.numpy(),
                               np.asarray(ref.rsquared), rtol=1e-5)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=5e-5)


