"""The XLA particle filter and PMMH (odelib_tpu_torch/samplers/pf.py)
against odelib_tpu's samplers/pf.py on the CPU, both in float64 (x64) from
the same keys: the random stream is bitwise, accept sequences exact,
chi and theta within 1e-8 relative (measured ~1e-15). The GBM state-space
model of tests/test_sde.py (8 observations on a 41-point grid): the filter
at K = 16, 32 and 100 with and without the filtered means; the
resampling's semantics (the reference's one-hot product: one diverged
particle at a middle block makes the estimate +inf, where a gather would
drop it; every weight dead, +inf); PMMH with and without adaptation, with
a prior and with Milstein; its checkpointed run; tune_particles; and
MCMC(sampler='pmmh') end to end where the kernel cannot run (100
particles) and under backend='xla'."""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.stats
import torch

import odelib_tpu
import odelib_tpu_torch
from odelib_tpu.distributions import LogNormal as JLogNormal
from odelib_tpu.model import ObsData, make_spec
from odelib_tpu.samplers import pf as JP
from odelib_tpu_torch import random as R
from odelib_tpu_torch.distributions import LogNormal
from odelib_tpu_torch.model import make_spec as t_make_spec
from odelib_tpu_torch.model import obsdata_from_arrays
from odelib_tpu_torch.samplers import pf as TP

RTOL = 1e-8
MU, SIG, S_OBS = 0.4, 0.3, 0.15
TIMES = np.linspace(0.0, 4.0, 41)
Y0 = np.array([2.0])


def _gbm_obs():
    rng = np.random.default_rng(42)
    t_obs = np.arange(1, 9) * 0.5
    z, zs = np.log(2.0), []
    for dt in np.diff(np.concatenate([[0.0], t_obs])):
        z = z + (MU - 0.5 * SIG ** 2) * dt + SIG * np.sqrt(dt) * rng.normal()
        zs.append(z)
    log_o = np.array(zs) + S_OBS * rng.normal(size=len(zs))
    return ObsData(log_abundance=log_o, log_sigma=np.full(len(log_o), S_OBS),
                   abundance=np.exp(log_o),
                   t_index=np.array([int(round(t / 0.1)) for t in t_obs]),
                   state_index=np.zeros(len(log_o), np.int64),
                   sstot=np.var(np.exp(log_o)) * len(log_o))


OBS = _gbm_obs()
TOBS = obsdata_from_arrays(OBS)
JSPEC = make_spec(lambda t, y, ps: jnp.stack([ps[0] * y[0]]), ("mu",),
                  ("N",), diffusion=lambda t, y, ps: jnp.stack([SIG * y[0]]))
TSPEC = t_make_spec(lambda t, y, ps: [ps[0] * y[0]], ("mu",), ("N",),
                    diffusion=lambda t, y, ps: [SIG * y[0]])


def _keys(C, seed=0):
    jk = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed),
                                               i))(jnp.arange(C))
    return jk, R.fold_in(R.PRNGKey(seed), torch.arange(C))


def _starts(C, seed=1):
    return MU * np.exp(np.random.default_rng(seed).normal(0, 0.1, (C, 1)))


_REF_PF = {}


@pytest.mark.parametrize("filtered", [False, True],
                         ids=["chi", "filtered"])
@pytest.mark.parametrize("K", [16, 32, 100])
def test_particle_filter_matches_reference(K, filtered):
    """Four parameter vectors and keys as one batch against the vmapped
    reference, Euler and (K = 100) Milstein."""
    th = _starts(4, seed=K)
    jk, tk = _keys(4, seed=K)
    method = "milstein" if K == 100 else "euler"
    if K not in _REF_PF:     # one reference compile serves both cases
        _REF_PF[K] = jax.vmap(lambda t, k: JP.particle_filter_chi(
            JSPEC, JP.obs_blocks(OBS), jnp.asarray(TIMES), jnp.asarray(Y0),
            t, k, n_particles=K, substeps=4, sde_method=method,
            return_filtered=True))(jnp.asarray(th), jk)
    ref = _REF_PF[K] if filtered else _REF_PF[K][0]
    got = TP.particle_filter_chi(
        TSPEC, TP.obs_blocks(TOBS), TIMES, np.tile(Y0, (4, 1)).T, th, tk,
        n_particles=K, substeps=4, sde_method=method,
        return_filtered=filtered, device="cpu")
    if filtered:
        (ref, ref_f), (got, got_f) = ref, got
        assert got_f.shape == (4, 8, 1)
        np.testing.assert_allclose(got_f.numpy(), np.asarray(ref_f),
                                   rtol=RTOL)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


def _blowup():
    """dN = a N^2 dt + 0.8 N dW observed at grid points 3, 6, 9 and 12:
    at a = 0.8 and key 3, one of 16 particles overflows during the third
    block and the others stay finite."""
    log_o = np.log(np.array([1.4, 2.0, 3.5, 8.0]))
    obs = ObsData(log_abundance=log_o, log_sigma=np.full(4, 0.5),
                  abundance=np.exp(log_o), t_index=np.array([3, 6, 9, 12]),
                  state_index=np.zeros(4, np.int64), sstot=1.0)
    jspec = make_spec(lambda t, y, ps: jnp.stack([ps[0] * y[0] * y[0]]),
                      ("a",), ("N",),
                      diffusion=lambda t, y, ps: jnp.stack([0.8 * y[0]]))
    tspec = t_make_spec(lambda t, y, ps: [ps[0] * y[0] * y[0]], ("a",),
                        ("N",), diffusion=lambda t, y, ps: [0.8 * y[0]])
    return obs, jspec, tspec, np.linspace(0.0, 2.0, 21)


def test_one_diverged_particle_at_a_middle_block_gives_inf(monkeypatch):
    """The reference resamples with sel @ parts: one particle's inf in
    block 2 of 4 puts NaN into every other particle's state (0 x inf), so
    every weight of block 3 is dead and the estimate is +inf. The port
    gives +inf too; a plain gather would have dropped the particle and
    given a finite estimate."""
    obs, jspec, tspec, times = _blowup()
    ref = JP.particle_filter_chi(jspec, JP.obs_blocks(obs),
                                 jnp.asarray(times), jnp.array([1.0]),
                                 jnp.array([0.8]), jax.random.PRNGKey(3),
                                 n_particles=16, substeps=10)
    args = (tspec, TP.obs_blocks(obsdata_from_arrays(obs)), times,
            np.array([1.0]), np.array([0.8]), R.PRNGKey(3))
    kw = dict(n_particles=16, substeps=10, device="cpu")
    diverged, real = [], TP.resample

    def spy(parts, cum, pos):
        diverged.append(int((~torch.isfinite(parts)).any(-1).sum()))
        return real(parts, cum, pos)
    monkeypatch.setattr(TP, "resample", spy)
    got = TP.particle_filter_chi(*args, **kw)
    assert float(ref) == float(got) == np.inf
    assert diverged == [0, 0, 1, 16]

    def gather(parts, cum, pos):
        j = torch.searchsorted(cum, pos, right=True).clamp(
            max=parts.shape[1] - 1)
        return parts.gather(1, j[..., None].expand_as(parts))
    monkeypatch.setattr(TP, "resample", gather)
    assert np.isfinite(float(TP.particle_filter_chi(*args, **kw)))
    # the resampling rows themselves: NaN unless a row copies the inf
    parts = torch.tensor([[[1.0, 2.0], [np.inf, 3.0], [4.0, 5.0]]],
                         dtype=torch.float64)
    w = torch.tensor([[0.5, 0.0, 0.5]], dtype=torch.float64)
    cum = torch.cumsum(w, -1)
    pos = torch.tensor([[0.1, 0.5, 0.9]], dtype=torch.float64)
    sel = ((pos[0][:, None] >= torch.cat([torch.zeros(1), cum[0, :-1]]))
           & (pos[0][:, None] < cum[0])).to(torch.float64)
    want = sel @ parts[0]
    np.testing.assert_array_equal(real(parts, cum, pos)[0].numpy(),
                                  want.numpy())
    assert torch.isnan(want[:, 0]).all()
    assert int((want[:, 1] == 2.0).sum()) == 1


def test_all_weights_dead_gives_inf():
    """A blow-up proposal: every particle non-finite, chi +inf in both
    (PMMH rejects it); NaN positions select nothing."""
    ref = JP.particle_filter_chi(JSPEC, JP.obs_blocks(OBS),
                                 jnp.asarray(TIMES), jnp.asarray(Y0),
                                 jnp.array([1e8]), jax.random.PRNGKey(0),
                                 n_particles=32, substeps=4)
    got = TP.particle_filter_chi(TSPEC, TP.obs_blocks(TOBS), TIMES, Y0,
                                 np.array([1e8]), R.PRNGKey(0),
                                 n_particles=32, substeps=4, device="cpu")
    assert float(ref) == float(got) == np.inf
    nan = torch.full((1, 4), np.nan, dtype=torch.float64)
    parts = torch.tensor([[[1.0], [2.0], [np.inf], [3.0]]],
                         dtype=torch.float64)
    out = TP.resample(parts, nan, nan)
    assert torch.isnan(out).all()
    out = TP.resample(torch.ones((1, 4, 1), dtype=torch.float64), nan, nan)
    assert (out == 0).all()


def _prior(pkg_dist):
    d = pkg_dist(s=0.5, scale=0.4)

    def logpdf(theta):
        return d.logpdf(theta[..., 0])
    return logpdf


def _assert_same(got, ref):
    np.testing.assert_array_equal(got.iteration.numpy(),
                                  np.asarray(ref.iteration))
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    for f in ("theta", "chi", "aic"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=RTOL,
                                   err_msg=f)


@pytest.mark.parametrize("case", ["plain", "adapt", "priors", "milstein"])
def test_pmmh_matches_reference(case):
    """Six chains of 12 iterations (burn-in 6), 16 particles: accept
    sequences exact."""
    C = 6
    jk, tk = _keys(C)
    th0 = _starts(C)
    kw = dict(nits=12, n_particles=16, substeps=2, rwalk_std=0.2)
    jkw, tkw = dict(kw), dict(kw)
    if case == "adapt":
        for d in (jkw, tkw):
            d.update(adapt_proposal=True, adapt_rate=0.2)
    if case == "priors":
        jkw.update(use_priors=True, prior_logpdf=_prior(JLogNormal))
        tkw.update(use_priors=True, prior_logpdf=_prior(LogNormal))
    if case == "milstein":
        for d in (jkw, tkw):
            d.update(sde_method="milstein")
    ref = JP.pmmh(JSPEC, OBS, TIMES, Y0, jnp.asarray(th0), jk, **jkw)
    got = TP.pmmh(TSPEC, TOBS, TIMES, Y0, th0, tk, device="cpu", **tkw)
    assert got.theta.shape == (C, 5, 1)
    _assert_same(got, ref)
    acc = got.acceptance_ratio[:, -1].numpy()
    assert 0 < acc.mean() < 1
    with pytest.raises(ValueError, match="burnin"):
        TP.pmmh(TSPEC, TOBS, TIMES, Y0, th0, tk, nits=10, burnin=9,
                device="cpu")


def test_pmmh_checkpointed_bitwise(tmp_path):
    """With adaptation: whole, 4 chunks of 3 (one straddling the
    burn-in), killed after two chunks and resumed: bitwise the whole
    run; a changed configuration is refused."""
    C = 4
    _, tk = _keys(C, seed=2)
    th0 = _starts(C, seed=3)
    kw = dict(nits=13, burnin=5, n_particles=8, substeps=2,
              adapt_proposal=True, adapt_rate=0.2)
    whole = TP.pmmh(TSPEC, TOBS, TIMES, Y0, th0, tk, device="cpu", **kw)
    path = str(tmp_path / "pf.progress")
    ck = dict(kw, checkpoint_every=3, checkpoint_path=path, device="cpu")
    chunks = TP.pmmh_checkpointed(TSPEC, TOBS, TIMES, Y0, th0, tk, **ck)
    assert TP.pmmh_checkpointed(TSPEC, TOBS, TIMES, Y0, th0, tk,
                                _stop_after_chunks=2, **ck) is None
    resumed = TP.pmmh_checkpointed(TSPEC, TOBS, TIMES, Y0, th0, tk,
                                   resume_from=path, **ck)
    for out in (chunks, resumed):
        for a, b in zip(out, whole):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="different PMMH configuration"):
        TP.pmmh_checkpointed(TSPEC, TOBS, TIMES, Y0, th0, tk,
                             resume_from=path, **dict(ck, n_particles=16))


def test_tune_particles_matches_reference():
    theta = np.array([MU])
    kw = dict(pilot_particles=16, n_reps=12, substeps=2)
    rk, rv = JP.tune_particles(JSPEC, OBS, TIMES, Y0, jnp.asarray(theta),
                               jax.random.PRNGKey(5), **kw)
    k, v = TP.tune_particles(TSPEC, TOBS, TIMES, Y0, theta, R.PRNGKey(5),
                             device="cpu", **kw)
    assert k == rk and k % 8 == 0
    np.testing.assert_allclose(v, rv, rtol=RTOL)
    with pytest.raises(ValueError, match="single"):
        TP.tune_particles(TSPEC, TOBS, TIMES, Y0, np.ones((2, 1)),
                          R.PRNGKey(0), device="cpu")
    with pytest.raises(ValueError, match="diverged"):
        TP.tune_particles(TSPEC, TOBS, TIMES, Y0, np.array([1e8]),
                          R.PRNGKey(0), device="cpu", **kw)


def _framework(pkg, **kw):
    df = pd.DataFrame({"organism": "N", "time": np.arange(1, 9) * 0.5,
                       "abundance": np.exp(OBS.log_abundance),
                       "log_sigma": S_OBS})

    def gbm(y, t, ps):
        return np.array([ps[0] * y[0]])

    def gnoise(y, t, ps):
        return np.array([SIG * y[0]])

    return pkg.ModelFramework(
        ODE=gbm, diffusion=gnoise, parameter_names=["mu"],
        state_names=["N"], dataframe=df, t_steps=41, N=2.0,
        mu=pkg.parameter(scipy.stats.lognorm, {"s": 0.5, "scale": 0.4},
                         random_seed=1), **kw)


@pytest.mark.parametrize("kw", [dict(n_particles=100),
                                dict(backend="xla", n_particles=128)],
                         ids=["100-particles", "backend-xla"])
def test_mcmc_pmmh_on_the_xla_filter_matches_reference(kw):
    """MCMC(sampler='pmmh') from explicit starts where the kernel does not
    run: the reference's posterior (its XLA pmmh, the chains keyed
    fold_in(PRNGKey(seed), i)), column by column; R^2 NaN."""
    starts = [{"mu": float(m)} for m in _starts(5, seed=7)[:, 0]]
    run = dict(chain_inits=starts, iterations_per_chain=10,
               sampler="pmmh", sde_substeps=2, rwalk_std=0.2,
               print_report=False, **kw)
    got = _framework(odelib_tpu_torch, device="cpu").MCMC(**run)
    ref = _framework(odelib_tpu).MCMC(**run)
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref) == 5 * 4
    for col in ref.columns:
        assert got[col].dtype == ref[col].dtype, col
    assert got["rsquared"].isna().all()
    for col in ("iteration", "chain#", "all_rejected", "acceptance_ratio"):
        np.testing.assert_array_equal(got[col].to_numpy(),
                                      ref[col].to_numpy())
    for col in ("mu", "chi", "aic"):
        np.testing.assert_allclose(got[col], ref[col], rtol=RTOL,
                                   err_msg=col)
    assert np.isfinite(got["chi"]).all()
