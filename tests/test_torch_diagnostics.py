"""The port's host utilities against ``odelib_tpu``'s: split-R-hat and
the effective sample size on seeded numpy chains (odd and even lengths,
mixing, sticky and stuck chains), and the posterior files' round trip and
restart points."""
import numpy as np
import pandas as pd
import pytest

from odelib_tpu.utils import checkpoint as JC
from odelib_tpu.utils import diagnostics as JD
from odelib_tpu_torch.utils import checkpoint as TC
from odelib_tpu_torch.utils import diagnostics as TD


def _chains(kind, C, N, seed):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(C, N))
    if kind == "iid":
        return e
    if kind == "ar1":               # sticky chains: lag-1 correlation 0.9
        x = np.empty_like(e)
        x[:, 0] = e[:, 0]
        for t in range(1, N):
            x[:, t] = 0.9 * x[:, t - 1] + np.sqrt(1 - 0.81) * e[:, t]
        return x
    # chains that never meet: a different offset each
    return e + 5.0 * np.arange(C)[:, None]


@pytest.mark.parametrize("N", [4, 5, 51, 200])
@pytest.mark.parametrize("kind", ["iid", "ar1", "apart"])
def test_diagnostics_match_odelib_tpu(kind, N):
    for C in (1, 4):
        x = _chains(kind, C, N, seed=N + C)
        np.testing.assert_allclose(TD.split_rhat(x), JD.split_rhat(x),
                                   rtol=1e-12)
        np.testing.assert_allclose(TD.effective_sample_size(x),
                                   JD.effective_sample_size(x), rtol=1e-12)
    # one chain as a 1-D array
    np.testing.assert_allclose(TD.effective_sample_size(x[0]),
                               JD.effective_sample_size(x[0]), rtol=1e-12)


def test_diagnostics_degenerate_inputs():
    stuck = np.ones((3, 10))
    assert np.isnan(TD.split_rhat(stuck)) and np.isnan(JD.split_rhat(stuck))
    assert np.isnan(TD.effective_sample_size(stuck))
    assert np.isnan(TD.effective_sample_size(np.ones((2, 3))))
    for mod in (TD, JD):
        with pytest.raises(ValueError, match="2 draws"):
            mod.split_rhat(np.ones((2, 1)))


def _posterior(seed=0):
    rng = np.random.default_rng(seed)
    C, R = 3, 4
    return pd.DataFrame({
        "mu": rng.lognormal(size=C * R), "beta": rng.normal(size=C * R),
        "chi": rng.random(C * R),
        "iteration": np.tile(np.arange(5, 5 + R), C),
        "chain#": np.repeat(np.arange(C), R),
        "all_rejected": np.zeros(C * R, bool)})


def test_posterior_files_round_trip(tmp_path):
    """save_posterior/load_posterior: the port's file loads back to the
    same frame, and the two packages' files hold the same arrays."""
    post = _posterior()
    ours, theirs = str(tmp_path / "a.post"), str(tmp_path / "b.post")
    TC.save_posterior(ours, post)
    JC.save_posterior(theirs, post)
    pd.testing.assert_frame_equal(TC.load_posterior(ours), post)
    pd.testing.assert_frame_equal(TC.load_posterior(theirs),
                                  JC.load_posterior(ours))
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_resume_theta_matches_odelib_tpu():
    post = _posterior(1)
    for n in (2, 3, 5):
        pd.testing.assert_frame_equal(
            TC.resume_theta(post, ["mu", "beta"], n),
            JC.resume_theta(post, ["mu", "beta"], n))
    last = TC.resume_theta(post, ["mu", "beta"], 3)
    np.testing.assert_array_equal(last["mu"].to_numpy(),
                                  post["mu"].to_numpy()[3::4])
