"""``MCMC(sampler='hmc')`` and ``get_chi_sensitivity`` through the user
API against odelib_tpu's on the CPU (x64): from the same chain_inits the
posterior frame column by column (iterations, chains and acceptance
ratios exact, the rest within 1e-8 relative), diagonal, and dense with
ChEES and a checkpointed, killed and resumed run; HMC's method map
('rk4' runs rk4, any other method fixed Dopri5, kvaerno3 too);
``backend='pallas'`` raising the reference's ValueError; the sensitivity
within 1e-8 of the reference's, in log and linear scale."""
import numpy as np
import pytest
import scipy.stats

import odelib_tpu
import odelib_tpu_torch

from helpers import demo_df, zero_i

INITS = [dict(mu=0.62, phi=2.3e-8, beta=25.0),
         dict(mu=0.55, phi=2.6e-8, beta=22.0),
         dict(mu=0.7, phi=2.0e-8, beta=30.0),
         dict(mu=0.6, phi=2.4e-8, beta=24.0)] * 2


def framework(pkg, **kw):
    return pkg.ModelFramework(
        ODE=zero_i, parameter_names=["mu", "phi", "beta"],
        state_names=["S", "V"], dataframe=demo_df(),
        mu=pkg.parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8}),
        phi=pkg.parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8}),
        beta=pkg.parameter(scipy.stats.lognorm, {"s": 1, "scale": 25}),
        t_steps=64, **kw)


def both():
    ref, got = framework(odelib_tpu), framework(odelib_tpu_torch,
                                                device="cpu")
    for fw in (ref, got):
        fw.set_parameters(mu=0.6, phi=2.4e-8, beta=24.0)
    return ref, got


def assert_same_frame(got, ref):
    assert list(got.columns) == list(ref.columns)
    for c in ref.columns:
        if c in ("iteration", "chain#", "acceptance_ratio", "all_rejected"):
            np.testing.assert_array_equal(got[c].to_numpy(),
                                          ref[c].to_numpy(), err_msg=c)
        else:
            np.testing.assert_allclose(got[c], ref[c], rtol=1e-8, err_msg=c)


@pytest.mark.parametrize("kw", [
    {}, dict(dense_mass=True, path_adapt=True, max_leapfrog=4),
    dict(method="rk4", use_priors=True)],
    ids=["diagonal", "dense-chees", "rk4-priors"])
def test_mcmc_hmc_matches_reference(kw):
    ref_fw, fw = both()
    run = dict(chain_inits=INITS, iterations_per_chain=10, sampler="hmc",
               print_report=False, **kw)
    ref = ref_fw.MCMC(backend="xla", **run)
    got = fw.MCMC(profile=True, **run)
    assert "chains[hmc]" in fw.last_profile
    assert len(got) == len(INITS) * 4
    assert_same_frame(got, ref)


def test_mcmc_hmc_checkpointed_resume_bitwise(tmp_path, monkeypatch):
    """checkpoint_every through the API: a run killed after its second
    chunk and resumed is the uninterrupted posterior, bitwise."""
    from odelib_tpu_torch.samplers import hmc
    _, fw = both()
    run = dict(chain_inits=INITS[:4], iterations_per_chain=9, sampler="hmc",
               n_leapfrog=2, print_report=False)
    whole = fw.MCMC(**run)
    path = str(tmp_path / "post.npz")
    ck = dict(run, checkpoint_every=3, checkpoint_path=path)
    real = hmc.hamiltonian_mc_checkpointed
    with monkeypatch.context() as m:
        m.setattr(hmc, "hamiltonian_mc_checkpointed",
                  lambda *a, **k: real(*a, _stop_after_chunks=2, **k))
        with pytest.raises(AttributeError):     # the killed run's None
            fw.MCMC(**ck)
    resumed = fw.MCMC(resume_from=path + ".progress", **ck)
    for c in whole.columns:
        np.testing.assert_array_equal(resumed[c].to_numpy(),
                                      whole[c].to_numpy(), err_msg=c)


def test_hmc_method_map_and_pallas():
    """'kvaerno3' (like every method but rk4) runs fixed Dopri5 in both
    packages, so its frame is 'dopri5''s; backend='pallas' raises."""
    _, fw = both()
    run = dict(chain_inits=INITS[:4], iterations_per_chain=6, sampler="hmc",
               n_leapfrog=2, print_report=False)
    a = fw.MCMC(**run)
    b = fw.MCMC(method="kvaerno3", **run)
    for c in a.columns:
        np.testing.assert_array_equal(a[c].to_numpy(), b[c].to_numpy())
    for sampler in ("hmc", "amh"):
        with pytest.raises(ValueError, match="runs on the XLA backend"):
            fw.MCMC(backend="pallas", **dict(run, sampler=sampler))


@pytest.mark.parametrize("log_scale,params", [
    (True, None), (False, [0.55, 2.6e-8, 22.0])],
    ids=["log-current", "linear-given"])
def test_chi_sensitivity_matches_reference(log_scale, params):
    ref_fw, fw = both()
    want = ref_fw.get_chi_sensitivity(params, log_scale=log_scale)
    got = fw.get_chi_sensitivity(params, log_scale=log_scale)
    assert set(got) == {"mu", "phi", "beta"}
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-8, err_msg=p)
