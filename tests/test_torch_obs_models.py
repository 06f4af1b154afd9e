"""Observation models: the port's ``stats.obs_negloglik`` against
``odelib_tpu.stats`` (float64, every family and censor flag), the survey
twin against the XLA survey and the interpret-mode survey kernel for each
family, and the MH, ensemble, PT, joint and PMMH twins against the JAX
kernels in interpret mode on Student-t, Poisson and negative-binomial
data: the same accept sequences over short runs. Kernel against twin on
the card is in tests/test_torch_cuda.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as ss
import torch

from odelib_tpu import stats as jstats
from odelib_tpu.data import obsdata_to_device
from odelib_tpu.model import make_spec as j_make_spec
from odelib_tpu.model import ObsData
from odelib_tpu.ops import pallas_joint as JJ
from odelib_tpu.ops import pallas_mh as J
from odelib_tpu.ops import pallas_pf as JF
from odelib_tpu.ops import pallas_pt as JP
from odelib_tpu.samplers import survey as jax_survey
from odelib_tpu_torch import stats as tstats
from odelib_tpu_torch.model import make_spec, obsdata_from_arrays
from odelib_tpu_torch.ops import cuda_joint as TJ
from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.ops import cuda_pf as TF
from odelib_tpu_torch.ops import cuda_pt as TP
from odelib_tpu_torch.rhs import adapt_rhs

from helpers import zero_i
from scoring_cases import COUNT_SCALE, FAMILIES, zero_i_case

_PARAMS = [("lognormal", 0.0), ("student_t", 1.0), ("student_t", 4.0),
           ("student_t", 100.0), ("poisson", 0.0), ("negbinom", 0.5),
           ("negbinom", 10.0)]


def _inputs(fam, censor, seed=0):
    """Observations (counts with zeros and a NaN), predictions (8 rows,
    with NaN, negative, zero and blown-up entries) and a censor column."""
    rng = np.random.default_rng(seed)
    N = 24
    O = rng.poisson(20.0, N).astype(float)
    O[:2] = [0.0, np.nan]
    C = O[None, :] * np.exp(rng.normal(0, 0.3, (8, N))) + 0.5
    C[1, 3], C[2, 4], C[3, 5], C[4, 6] = np.nan, -1.0, 0.0, np.inf
    S = rng.uniform(0.2, 0.8, N)
    cen = None
    if censor == "mixed":
        cen = rng.integers(0, 3, N).astype(np.int32)
    elif censor == "exact":
        cen = np.zeros(N, np.int32)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.log(O), np.log(C), S, O, C, cen


@pytest.mark.parametrize("censor", ["none", "exact", "mixed"])
@pytest.mark.parametrize("fam,param", _PARAMS,
                         ids=[f"{f}-{p:g}" for f, p in _PARAMS])
def test_obs_negloglik_matches_odelib_tpu(fam, param, censor):
    """Every family and censor flag, censored counts included: within
    1e-10 relative where the reference is finite, and non-finite where it
    is (NaN and negative predictions, zero counts, blow-ups)."""
    args = _inputs(fam, censor)
    with np.errstate(all="ignore"):
        ref = np.asarray(jstats.obs_negloglik(fam, param, *args[:5],
                                              censor=args[5]))
    got = tstats.obs_negloglik(fam, param, *args[:5],
                               censor=args[5]).numpy()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert fin.sum() >= 3
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-10)


def test_formulas_match_scipy():
    """Differences of the count and Student-t scores are scipy's
    log-likelihood differences (the constants cancel)."""
    rng = np.random.default_rng(0)
    O = rng.poisson(5.0, 30).astype(float)
    C1, C2 = rng.uniform(1, 10, 30), rng.uniform(1, 10, 30)
    with np.errstate(divide="ignore"):
        lO = np.log(O)

    def nll(fam, p, C, logO=lO, S=np.ones(30), obs=O):
        return float(tstats.obs_negloglik(fam, p, logO, np.log(C), S, obs,
                                          C))
    d = nll("poisson", 0.0, C1) - nll("poisson", 0.0, C2)
    assert abs(d - (ss.poisson.logpmf(O, C2).sum()
                    - ss.poisson.logpmf(O, C1).sum())) < 1e-8
    r = 3.5
    d = nll("negbinom", r, C1) - nll("negbinom", r, C2)
    assert abs(d - (ss.nbinom.logpmf(O, r, r / (r + C2)).sum()
                    - ss.nbinom.logpmf(O, r, r / (r + C1)).sum())) < 1e-8
    Ol, S = rng.normal(0, 1, 30), rng.uniform(0.2, 2, 30)
    L1, L2 = rng.normal(0, 1, 30), rng.normal(0, 1, 30)
    d = float(tstats.obs_negloglik("student_t", 4.0, Ol, L1, S)
              - tstats.obs_negloglik("student_t", 4.0, Ol, L2, S))
    assert abs(d - (ss.t.logpdf((Ol - L2) / S, 4.0).sum()
                    - ss.t.logpdf((Ol - L1) / S, 4.0).sum())) < 1e-8


def test_make_spec_validation():
    with pytest.raises(ValueError, match="obs_model"):
        make_spec(adapt_rhs(zero_i), ("a",), ("S",), obs_model="gaussian")
    with pytest.raises(ValueError, match="dispersion"):
        make_spec(adapt_rhs(zero_i), ("a",), ("S",), obs_model="negbinom")
    with pytest.raises(ValueError, match="degrees of freedom"):
        make_spec(adapt_rhs(zero_i), ("a",), ("S",), obs_model="student_t",
                  obs_param=-1)
    assert make_spec(adapt_rhs(zero_i), ("a",), ("S",),
                     obs_model="student_t").obs_param == 4.0


def jax_twin_spec(tspec, rhs=zero_i):
    """The JAX package's spec of the port's ``tspec`` (same observation
    model and doses) with the JAX-side ``rhs``."""
    return j_make_spec(rhs, tspec.pnames, tspec.snames,
                       obs_model=tspec.obs_model,
                       obs_param=tspec.obs_param or None,
                       dose_events=tspec.dose_events)


# the MH, joint and PT parity cases keep every other sampling time of the
# demo (scoring_cases.demo_frame): the interpret-mode JAX kernels' programs
# grow with the grid, and on 9 points they compile ~8x faster than on 18
THIN = 2


def fam_case(fam, censor=(), dosed=False, thin=1):
    """(JAX spec, port spec, obs, grid, y0, theta centre) of zero_i on
    the demo data under ``fam`` (``thin``: scoring_cases.demo_frame)."""
    scale = COUNT_SCALE.get(fam, 1.0)
    tspec, obs, tf, y0 = zero_i_case(fam, censor, dosed, scale=scale,
                                     thin=thin)
    return (jax_twin_spec(tspec), tspec, obs, tf, y0,
            np.array([0.6, 2.4e-8 * scale, 24.0]))


def draws(centre, n, sd, seed=0):
    rng = np.random.default_rng(seed)
    return (np.asarray(centre) * np.exp(rng.normal(0, sd, (n, len(centre))))
            ).astype(np.float32)


def xla_survey(jspec, obs, tf, y0, th, substeps):
    return np.asarray(jax_survey(
        jspec, obsdata_to_device(obs, jnp.float32),
        jnp.asarray(tf, jnp.float32), jnp.asarray(y0, jnp.float32),
        jnp.asarray(th, jnp.float32), method="fixed_dopri5",
        substeps=substeps))


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_survey_twin_matches_xla_survey(fam):
    """The float32 twin against the XLA survey's fixed-step Dopri5 (the
    reference's exact likelihood): within rtol 1e-5."""
    jspec, tspec, obs, tf, y0, centre = fam_case(fam)
    th = draws(centre, 16, 0.2)
    ref = xla_survey(jspec, obs, tf, y0, th, 2)
    got = T.survey_fused(tspec, obs, tf, y0, torch.as_tensor(th),
                         substeps=2).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("fam", ["student_t", "poisson", "negbinom"])
def test_survey_twin_matches_pallas_interpret(fam):
    """Against the JAX survey kernel in interpret mode, within the
    lognormal survey's rtol 1e-5 (tests/test_torch_survey.py)."""
    jspec, tspec, obs, tf, y0, centre = fam_case(fam)
    th = draws(centre, 16, 0.2)
    ref = np.asarray(J.survey_fused(jspec, obs, tf, y0, th, substeps=2,
                                    tile_chains=128, interpret=True))
    got = T.survey_fused(tspec, obs, tf, y0, torch.as_tensor(th),
                         substeps=2).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def assert_same_chains(got, ref, theta_rtol=1e-5, chi_rtol=5e-5):
    """Equal accept sequences (the running ratio is an exact function of
    them), theta and chi within the MH parity tolerances."""
    np.testing.assert_array_equal(got.iteration.numpy(),
                                  np.asarray(ref.iteration))
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    acc = float(got.acceptance_ratio[:, -1].mean())
    assert 0 < acc < 1, acc
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=theta_rtol)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=chi_rtol)


def run_mh(jspec, tspec, obs, tf, y0, th0, **kw):
    ref = J.metropolis_hastings_fused(jspec, obs, tf, y0, th0, seed=7,
                                      tile_chains=128, interpret=True, **kw)
    got = T.metropolis_hastings_fused(tspec, obs, tf, y0,
                                      torch.as_tensor(th0), 7, **kw)
    return got, ref


_MH_KW = dict(nits=16, burnin=6, substeps=1)


@pytest.mark.parametrize("fam", ["student_t", "poisson", "negbinom"])
def test_mh_twin_matches_pallas_interpret(fam):
    """MH on each family (the thinned demo): the JAX kernel's accept
    sequences."""
    jspec, tspec, obs, tf, y0, centre = fam_case(fam, thin=THIN)
    got, ref = run_mh(jspec, tspec, obs, tf, y0, draws(centre, 128, 0.03),
                      **_MH_KW)
    assert_same_chains(got, ref)


@pytest.mark.parametrize("fam", ["student_t", "poisson", "negbinom"])
def test_joint_twin_matches_pallas_interpret(fam):
    """Two experiments of one model with their own observation models
    (``fam`` and lognormal) tied in all three parameters: each is scored
    by its own branch, and the accept sequences are the JAX kernel's
    (the thinned demo)."""
    jspec, tspec, obs, tf, y0, centre = fam_case(fam, thin=THIN)
    jl, tl, obs_l, tf_l, y0_l, _ = fam_case("lognormal", thin=THIN)
    if fam == "poisson":   # the lognormal member on the same scaled data
        obs_l = obs._replace(censor=None)
        tf_l, y0_l = tf, y0
    th0 = draws(centre, 128, 0.03)
    kw = dict(nits=12, burnin=4, substeps_list=[1, 1])
    args = ((0, 1, 2), (0, 1, 2)), (obs, obs_l), (tf, tf_l), (y0, y0_l)
    ref = JJ.joint_metropolis_hastings_fused(
        (jspec, jl), *args, th0, seed=4, tile_chains=128, interpret=True,
        **kw)
    got = TJ.joint_metropolis_hastings_fused(
        (tspec, tl), *args, torch.as_tensor(th0), 4, **kw)
    assert_same_chains(got, ref)
    np.testing.assert_allclose(got.chi_parts.numpy(),
                               np.asarray(ref.chi_parts), rtol=5e-5)


def _gbm(t, y, ps):
    return jnp.stack([ps[0] * y[0]])


def _gbm_noise(t, y, ps):
    return jnp.stack([0.3 * y[0]])


def gbm_case(fam, dose_events=None):
    """The GBM state-space model of tests/test_torch_pf.py (numpy seed
    42) under ``fam``: counts are 50 N rounded, from N0 = 100."""
    rng = np.random.default_rng(42)
    t_obs = np.arange(1, 9) * 0.5
    z, zs = np.log(2.0), []
    for dt in np.diff(np.concatenate([[0.0], t_obs])):
        z = z + (0.4 - 0.045) * dt + 0.3 * np.sqrt(dt) * rng.normal()
        zs.append(z)
    log_o = np.array(zs) + 0.15 * rng.normal(size=8)
    y0 = np.array([2.0])
    if fam in ("poisson", "negbinom"):
        ab = np.round(50.0 * np.exp(log_o))
        log_o, y0 = np.log(ab), y0 * 50.0
    obs = ObsData(log_abundance=log_o, log_sigma=np.full(8, 0.15),
                  abundance=np.exp(log_o),
                  t_index=np.round(t_obs / 0.1).astype(np.int64),
                  state_index=np.zeros(8, np.int64),
                  sstot=float(np.var(np.exp(log_o)) * 8))
    par = FAMILIES[fam]
    jspec = j_make_spec(_gbm, ("mu",), ("N",), diffusion=_gbm_noise,
                        obs_model=fam, obs_param=par,
                        dose_events=dose_events)
    tspec = make_spec(adapt_rhs(_gbm), ("mu",), ("N",),
                      diffusion=adapt_rhs(_gbm_noise), obs_model=fam,
                      obs_param=par, dose_events=dose_events)
    th0 = np.exp(np.random.default_rng(1).normal(np.log(0.4), 0.3,
                                                 (128, 1)))
    return (jspec, tspec, obs, np.linspace(0, 4.0, 41), y0,
            th0.astype(np.float32))


def run_pmmh(jspec, tspec, obs, times, y0, th0, K=16):
    kw = dict(nits=7, burnin=3, rwalk_std=0.3, n_particles=K, substeps=1)
    ref = JF.pmmh_fused(jspec, obs, times, y0.astype(np.float32), th0,
                        seed=3, interpret=True, **kw)
    got = TF.pmmh_fused(tspec, obsdata_from_arrays(obs), times, y0,
                        torch.as_tensor(th0), 3, **kw)
    return got, ref


def assert_same_filters(got, ref):
    """Equal accept sequences and theta; chi within the PMMH parity
    tolerance 5e-6 (tests/test_torch_pf.py) but where a systematic-
    resampling selection within an ulp of its edge went the other way in
    the two math libraries: with count data's peaked weights such a chain
    (one of 128 in the Poisson case, chain 102's first filter) moves by a
    few 1e-5, so 99 % of the records are held at 5e-6 and all at 1e-4."""
    assert_same_chains(got, ref, theta_rtol=1e-6, chi_rtol=1e-4)
    rel = np.abs(got.chi.numpy() - np.asarray(ref.chi)) \
        / np.abs(np.asarray(ref.chi))
    assert np.mean(rel <= 5e-6) >= 0.99


@pytest.mark.parametrize("fam", ["student_t", "poisson", "negbinom"])
def test_pmmh_twin_matches_pallas_interpret(fam):
    """The particle filter weighs each family's terms (the MH scorer's,
    through ``obs_terms``): the JAX kernel's accept sequences."""
    got, ref = run_pmmh(*gbm_case(fam))
    assert_same_filters(got, ref)
