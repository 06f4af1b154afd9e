"""A long ensemble run on the demo in both packages, from the same start
points: ``mu`` underflows in nearly every walker, and odelib_tpu's Pallas
kernel (interpret mode) does the same as the port's twin.

``mu`` is not pinned by the demo data (MH gives it a standard deviation
four orders above its median), and stretch moves act on log-theta, so an
ensemble spread along a flat direction keeps stretching until ``exp``
underflows. "Underflowed" here is below float32's smallest normal: the
reference's XLA:CPU flushes denormals to 0, the port keeps them, so
``mu == 0`` alone would count the same walkers at different iterations.
Measured (CPU, 256 walkers seeded from the port's survey, one ensemble of
256, substeps=1): the first walker underflows at iteration 41 in both; the
accept sequences are equal up to iteration 62, and so is the underflowed
share at every iteration (8.6 % at 62); after that the two runs part by
ulps and the shares differ by at most 0.047; at iteration 299 they are
0.996 (reference) and 1.0 (port).
"""
import contextlib
import io

import numpy as np
import scipy.stats

import odelib_tpu
import odelib_tpu_torch

from odelib_tpu_torch import dispatch as t_dispatch

from helpers import demo_df, zero_i


def _framework(pkg, **kw):
    """The demo fit with seeded priors, so the port's survey, and with it
    the walkers' start points, is the same in every run."""
    return pkg.ModelFramework(
        ODE=zero_i, parameter_names=["mu", "phi", "beta"],
        state_names=["S", "V"], dataframe=demo_df(),
        mu=pkg.parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8},
                         random_seed=1),
        phi=pkg.parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8},
                          random_seed=2),
        beta=pkg.parameter(scipy.stats.lognorm, {"s": 1, "scale": 25},
                           random_seed=3),
        t_steps=288, substeps=1, **kw)


def _table(post, col):
    return post.pivot(index="chain#", columns="iteration",
                      values=col).to_numpy()


def test_mu_underflow_share_matches_reference(monkeypatch):
    kw = dict(iterations_per_chain=300, burnin=0, sampler="ensemble",
              backend="pallas", pallas_tile_chains=256, print_report=False)
    seen = {}

    def capture(fw_, theta0, cfg):
        seen["theta0"] = np.asarray(theta0, np.float32)
        return t_dispatch.run_fused_ensemble(fw_, theta0, cfg)

    # the port seeds its walkers from the survey, as the main path does;
    # the reference starts from the same points
    monkeypatch.setitem(t_dispatch._ARMS, "cpu:ensemble", capture)
    with contextlib.redirect_stdout(io.StringIO()):
        got = _framework(odelib_tpu_torch, device="cpu").MCMC(
            chain_inits=256, fitsurvey_samples=1000, sd_fitdistance=6.0,
            **kw)
        inits = [dict(zip(("mu", "phi", "beta"), map(float, row)))
                 for row in seen["theta0"]]
        ref = _framework(odelib_tpu).MCMC(
            chain_inits=inits, pallas_interpret=True, **kw)
    tiny = np.finfo(np.float32).tiny
    for post in (got, ref):     # the collapse is mu's alone
        assert (post.phi >= tiny).all() and (post.beta >= tiny).all()
    its = np.arange(1, 300)
    steps = [np.diff(np.round(_table(p, "acceptance_ratio") * its),
                     prepend=0.0, axis=1) for p in (ref, got)]
    parted = (steps[0] != steps[1]).any(0)
    first_part = int(its[parted.argmax()]) if parted.any() else 300
    shares = [(_table(p, "mu") < tiny).mean(0) for p in (ref, got)]
    onset = [int(its[(sh > 0).argmax()]) for sh in shares]
    gap = np.abs(shares[0] - shares[1])
    print(f"underflow onset {onset}, accept sequences part at "
          f"{first_part}, max share gap {gap.max()}, final shares "
          f"{shares[0][-1]} {shares[1][-1]}")
    # the collapse starts while both packages make the same decisions
    assert onset[0] == onset[1] < first_part
    np.testing.assert_array_equal(shares[0][:first_part - 1],
                                  shares[1][:first_part - 1])
    assert gap.max() <= 0.06                        # measured 0.047
    assert shares[0][-1] > 0.95 and shares[1][-1] > 0.95
