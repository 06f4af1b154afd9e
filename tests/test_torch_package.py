"""Package-level checks of odelib_tpu_torch: it never imports jax, its
distributions match scipy, and its LHS draws fill every stratum."""
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.stats
import torch

from odelib_tpu_torch import distributions as D
from odelib_tpu_torch.samplers.lhs import lhs_unit, sample_lhs

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_out():
    code = ("import sys, odelib_tpu_torch, odelib_tpu_torch.api, "
            "odelib_tpu_torch.ops.cuda_mh, odelib_tpu_torch.ops.build, "
            "odelib_tpu_torch.models, odelib_tpu_torch.dispatch; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'odelib_tpu.'))"
            " or m == 'odelib_tpu']; print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


_DISTS = [
    (D.LogNormal(s=3.0, scale=1e-8), scipy.stats.lognorm(3.0, scale=1e-8)),
    (D.LogNormal(s=1.0, loc=0.5, scale=25.0),
     scipy.stats.lognorm(1.0, loc=0.5, scale=25.0)),
    (D.Normal(loc=2.0, scale=0.3), scipy.stats.norm(2.0, 0.3)),
    (D.Uniform(loc=-1.0, scale=4.0), scipy.stats.uniform(-1.0, 4.0)),
]


@pytest.mark.parametrize("d,ref", _DISTS,
                         ids=["lognorm", "lognorm-loc", "norm", "uniform"])
def test_logpdf_ppf_cdf_match_scipy(d, ref):
    q = np.linspace(0.01, 0.99, 57)
    x = ref.ppf(q)
    np.testing.assert_allclose(d.ppf(q).numpy(), x, rtol=1e-6)
    np.testing.assert_allclose(d.logpdf(x).numpy(), ref.logpdf(x),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d.cdf(x).numpy(), q, rtol=1e-6)
    g = torch.Generator().manual_seed(3)
    draws = d.rvs(g, (4000,)).numpy()
    assert scipy.stats.kstest(draws, ref.cdf).pvalue > 1e-3


def test_from_scipy_bridge():
    d = D.from_scipy(scipy.stats.lognorm, {"s": 3, "scale": 1e-8})
    assert d == D.LogNormal(s=3.0, scale=1e-8) and hash(d)
    assert D.from_scipy(scipy.stats.norm(1.0, 2.0)) == D.Normal(1.0, 2.0)
    with pytest.raises(NotImplementedError, match="not ported"):
        D.from_scipy(scipy.stats.gamma, {"a": 2.0})


def test_lhs_one_draw_per_stratum():
    n, dims = 50, 4
    g = torch.Generator().manual_seed(0)
    cube = lhs_unit(g, dims, n).numpy()
    assert cube.shape == (n, dims) and ((cube > 0) & (cube < 1)).all()
    for j in range(dims):
        np.testing.assert_array_equal(np.sort(np.floor(cube[:, j] * n)),
                                      np.arange(n))
    draws = sample_lhs(torch.Generator().manual_seed(0),
                       [D.LogNormal(s=1.0, scale=25.0)] * 2, n).numpy()
    ref = scipy.stats.lognorm(1.0, scale=25.0)
    for j in range(2):
        np.testing.assert_array_equal(
            np.sort(np.floor(ref.cdf(draws[:, j]) * n + 1e-9)), np.arange(n))


def _stats_inputs():
    rng = np.random.default_rng(4)
    O = rng.normal(15.0, 1.0, (3, 20))
    O[0, 3] = np.nan                       # invalid observations mask out
    C = O + rng.normal(0, 0.2, (3, 20))
    S = rng.uniform(0.1, 0.3, 20)
    return O, C, S


_STATS = {
    "chi": lambda m, O, C, S: m.chi(O, C, S),
    "AIC": lambda m, O, C, S: m.AIC(m.chi(O, C, S), 3),
    "obs_negloglik": lambda m, O, C, S: m.obs_negloglik(
        "lognormal", 0.0, O, C, S, np.exp(O), np.exp(C)),
    "Rsqrd": lambda m, O, C, S: m.Rsqrd({"a": np.exp(C[1]), "b": C[2]},
                                        {"a": np.exp(O[1]), "b": O[2]}),
    "rsqrd_flat": lambda m, O, C, S: m.rsqrd_flat(C[1:], O[1:], 1e3 * S.sum()),
    "adjusted": lambda m, O, C, S: m.get_adjusted_rsquared(0.91, 37, 3),
    "rawstats": lambda m, O, C, S: m.rawstats(np.exp(O[1:])),
}


@pytest.mark.parametrize("name", sorted(_STATS))
def test_stats_match_odelib_tpu(name):
    """The port's stats (torch, float64) against odelib_tpu's (jnp, x64)."""
    from odelib_tpu import stats as jstats
    from odelib_tpu_torch import stats as tstats
    args = _stats_inputs()
    ref = _STATS[name](jstats, *args)
    got = _STATS[name](tstats, *args)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(torch.as_tensor(g).numpy(), np.asarray(r),
                                   rtol=1e-12)
