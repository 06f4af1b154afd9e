"""The scorer's cases, one definition for ``chip_smoke.py`` and the tests
(``tests/test_torch_scoring.py`` and the files that import it, and the
card tests): each compiled scoring branch, the demo data as each
observation model sees it (counts rounded, host points below 1.5e6
left-censored there, virus points above 2.5e8 right-censored there),
zero_i with a virus inoculum, pk_oral with six oral doses and points
under the LLOQ, the stiff Robertson system on ``bench/suite.py``'s
config-5 grid, and the shapes above the kernels' old limits: two_i with
n latent classes (n + 2 states), Lotka-Volterra data for long PT ladders
and chemostat runs at many dilution rates for joint fits. Imports neither
jax nor the JAX package."""
import numpy as np
import pandas as pd
import torch

from odelib_tpu_torch.data import (build_obsdata_host,
                                   compact_observation_grid,
                                   format_dataframe, load_demo_dataframe)
from odelib_tpu_torch.model import make_spec
from odelib_tpu_torch.distributions import LogNormal
from odelib_tpu_torch.models import (chemostat, lotka_volterra, pk_oral,
                                     robertson, two_i, zero_i)
from odelib_tpu_torch.rhs import adapt_rhs

FAMILIES = {"lognormal": None, "student_t": 4.0, "poisson": None,
            "negbinom": 10.0}
LOD_HOST, ULOQ_VIRUS = 1.5e6, 2.5e8
ZERO_I_DOSE = (1.0, "V", 2.0e7)     # a virus inoculum at t = 1
PK_DOSES = tuple((12.0 * i, "A_gut", 100.0) for i in range(6))

# (observation model, censoring, dosed): each of the scorer's compiled
# branches beside the demo's (lognormal, exact, undosed); the count models
# take no censoring in the kernels
SCORING = (("lognormal", ("left", "right"), False),
           ("lognormal", (), True),
           ("lognormal", ("left", "right"), True),
           ("student_t", (), False),
           ("student_t", ("left", "right"), False),
           ("student_t", (), True),
           ("student_t", ("left", "right"), True),
           ("poisson", (), False), ("poisson", (), True),
           ("negbinom", (), False), ("negbinom", (), True))
# the Poisson cases' counts are the demo's / 1e5 (15 to 3,000): Poisson
# chi grows with the counts, and at / 1e4 (chi ~ -1.9e6) its float32 step
# of 0.125 lets two math libraries' log ulps flip an accept whose ratio is
# within ~0.1 nats of its uniform
COUNT_SCALE = {"poisson": 1e5}


def scoring_id(case):
    fam, censor, dosed = case
    return "-".join([fam] + (["censored"] if censor else [])
                    + (["dosed"] if dosed else []))


def demo_frame(obs_model="lognormal", censor=(), scale=1.0, host="S",
               thin=1, first=None):
    """The demo data (``host``, V) as ``obs_model`` sees it: divided by
    ``scale`` and rounded to counts for the count models; ``censor`` holds
    'left' (host points below 1.5e6 recorded at that limit) and/or
    'right' (virus points above 2.5e8 recorded at that limit), labelled
    in a ``censored`` column. ``thin`` keeps every thin-th sampling time
    from t = 0 (2: 9 of 18, both censored sides kept), which makes the
    interpret-mode JAX kernels' programs several times cheaper to
    compile; ``first`` keeps only the first that many of those times."""
    df = load_demo_dataframe(host=host, virus="V")
    df = df[df["time"].isin(np.unique(df["time"])[::thin][:first])]
    df = df.reset_index(drop=True)
    if obs_model in ("poisson", "negbinom"):
        df["abundance"] = np.round(df["abundance"] / scale)
    if censor:
        labels = np.full(len(df), "", object)
        if "left" in censor:
            low = ((df["organism"] == host) & (df["abundance"] < LOD_HOST))
            df.loc[low, "abundance"] = LOD_HOST
            labels[low.to_numpy()] = "left"
        if "right" in censor:
            high = ((df["organism"] == "V")
                    & (df["abundance"] > ULOQ_VIRUS))
            df.loc[high, "abundance"] = ULOQ_VIRUS
            labels[high.to_numpy()] = "right"
        df["censored"] = labels
    return df


def fit_inputs(spec, df, t_steps):
    """(host obs on the compact grid, the grid): the framework's own
    construction, the dose times kept on the grid."""
    times = np.linspace(0, df["time"].max(), t_steps)
    obs, _ = build_obsdata_host(df, times, spec.post_snames)
    return compact_observation_grid(
        obs, times, extra_times=[t for t, _, _ in spec.dose_events or ()])[
            ::-1]


def zero_i_case(obs_model="lognormal", censor=(), dosed=False,
                t_steps=288, scale=1.0, thin=1):
    """(spec, host obs, grid, y0) of zero_i on the demo data (counts and
    the dose divided by ``scale``: the fit's phi is then 2.4e-8 ``scale``;
    ``thin`` as :func:`demo_frame`)."""
    t, s, amt = ZERO_I_DOSE
    spec = make_spec(adapt_rhs(zero_i.rhs, "jax"), zero_i.pnames,
                     zero_i.snames, obs_model=obs_model,
                     obs_param=FAMILIES[obs_model],
                     dose_events=((t, s, amt / scale),) if dosed else None)
    df = format_dataframe(demo_frame(obs_model, censor, scale, thin=thin),
                          zero_i.snames)
    obs, tf = fit_inputs(spec, df, t_steps)
    y0 = np.array([df.loc["S"].iloc[0]["abundance"],
                   df.loc["V"].iloc[0]["abundance"]])
    return spec, obs, tf, y0


def pk_frame(censored=True, seed=0, thin=1):
    """pk_oral concentrations every 2 h over 72 h under six 100-unit
    doses every 12 h, log-normal noise of sd 0.2 (numpy ``seed``); with
    ``censored`` the points under the LLOQ, the 20th percentile, are
    recorded at it and left-censored (7 of 36). ``thin`` keeps every
    thin-th point, ending at 72 h (2: every 4 h, the dose times among
    them)."""
    from scipy.integrate import solve_ivp
    ka, ke, V = pk_oral.default_theta
    t_obs = np.arange(2.0, 73.0, 2.0)
    y, t0, conc = np.array([0.0, 0.0]), 0.0, []
    for td in [12.0 * i for i in range(6)] + [np.inf]:
        seg = t_obs[(t_obs > t0) & (t_obs <= td)]
        if len(seg):
            sol = solve_ivp(lambda t, u: [-ka * u[0],
                                          ka * u[0] / V - ke * u[1]],
                            (t0, seg[-1]), y, t_eval=seg, rtol=1e-10,
                            atol=1e-12)
            conc.extend(sol.y[1])
        if np.isinf(td):
            break
        sol = solve_ivp(lambda t, u: [-ka * u[0],
                                      ka * u[0] / V - ke * u[1]],
                        (t0, td), y, rtol=1e-10, atol=1e-12) \
            if td > t0 else None
        y = (sol.y[:, -1] if sol is not None else y) + [100.0, 0.0]
        t0 = td
    rng = np.random.default_rng(seed)
    ab = np.asarray(conc) * np.exp(0.2 * rng.normal(size=len(t_obs)))
    df = pd.DataFrame({"organism": "C", "time": t_obs, "abundance": ab,
                       "log_sigma": 0.2})
    if censored:
        lloq = float(np.quantile(ab, 0.2))
        cen = ab < lloq
        df["abundance"] = np.where(cen, lloq, ab)
        df["censored"] = cen
    return df.iloc[thin - 1::thin].reset_index(drop=True)


def pk_case(censored=True, obs_model="lognormal", t_steps=145, thin=1):
    """(spec, host obs, grid, y0) of dosed pk_oral (y0 = 0; the first
    dose at t = 0; ``thin`` as :func:`pk_frame`)."""
    spec = make_spec(adapt_rhs(pk_oral.rhs, "jax"), pk_oral.pnames,
                     pk_oral.snames, obs_model=obs_model,
                     obs_param=FAMILIES[obs_model], dose_events=PK_DOSES)
    df = format_dataframe(pk_frame(censored, thin=thin), pk_oral.snames)
    obs, tf = fit_inputs(spec, df, t_steps)
    return spec, obs, tf, np.zeros(2)


# Robertson as bench/suite.py's config 5 solves it: its rates, y0 and grid
ROBERTSON_TIMES = np.concatenate([[0.0], np.geomspace(1e-5, 1e3, 31)])
# the framework snaps observations to linspace(0, 1e3, t_steps): spaced
# 1e-3, the first interval is [0, 1e-3], and four fixed Kvaerno3 steps
# from y2 = y3 = 0 converge there (the step's one Jacobian, taken where
# y2 = 0, holds none of the -2 k2 y2 stiffness the stage meets; at the
# default t_steps the first interval is [0, 1] and its chord Newton
# diverges, in odelib_tpu as in the port). Each time moves to the nearest
# grid point, by at most 4.9e-4: the seven below 5e-4 to t = 0, 7.4e-4 and
# 1.4e-3 both to 1e-3, 2.5e-3 to 3e-3, those from 0.016 on by under 1 %
ROBERTSON_T_STEPS = 1_000_001


def robertson_frame(seed=5):
    """Robertson's states at ``ROBERTSON_TIMES`` from (1, 0, 0) at the
    default rates (scipy LSODA, rtol 1e-10, atol 1e-14) with log-normal
    noise of sd 0.1 (numpy ``seed``) on the states positive at every
    time: y1 (y2 and y3 start at 0)."""
    from scipy.integrate import odeint
    k1, k2, k3 = robertson.default_theta

    def f(y, t):
        return [-k1 * y[0] + k3 * y[1] * y[2],
                k1 * y[0] - k2 * y[1] ** 2 - k3 * y[1] * y[2],
                k2 * y[1] ** 2]
    ys = odeint(f, list(robertson.default_y0), ROBERTSON_TIMES, rtol=1e-10,
                atol=1e-14, mxstep=1000000)
    rng = np.random.default_rng(seed)
    rows = []
    for s, name in enumerate(robertson.snames):
        if (ys[:, s] > 0).all():
            rows.append(pd.DataFrame({
                "organism": name, "time": ROBERTSON_TIMES,
                "abundance": ys[:, s] * np.exp(
                    0.1 * rng.normal(size=len(ROBERTSON_TIMES))),
                "log_sigma": 0.1}))
    return pd.concat(rows, ignore_index=True)


# -- models of any size, long ladders and many experiments --------------------

def chain_rhs(n, stack=None):
    """two_i generalised to ``n`` latent classes (a user RHS, torch's, or
    with ``stack`` another array library's): dI1 = phi S V - tau I1, dIk
    = tau I(k-1) - tau Ik, the last class lyses at lam, dV = beta lam In
    - phi S V; states S, I1..In, V."""
    def rhs(t, y, ps):
        mu, phi, beta, lam, tau = ps
        S, V = y[0], y[n + 1]
        dI = [phi * S * V - tau * y[1]]
        dI += [tau * y[k - 1] - tau * y[k] for k in range(2, n)]
        dI.append(tau * y[n - 1] - lam * y[n])
        out = [mu * S - phi * S * V] + dI + [beta * lam * y[n] - phi * S * V]
        return torch.stack(out) if stack is None else stack(out)
    return rhs


CHAIN_PNAMES = ("mu", "phi", "beta", "lam", "tau")


def chain_snames(n):
    return ("S",) + tuple(f"I{k}" for k in range(1, n + 1)) + ("V",)


def chain_summations(n):
    """The observed host H = S + I1 + ... + In."""
    return {"H": ["S"] + [f"I{k}" for k in range(1, n + 1)]}


def chain_theta(n):
    """two_i's starts with tau scaled by n - 1, so that the mean latent
    period (n - 1)/tau + 1/lam is two_i's 1/tau + 1/lam."""
    mu, phi, beta, lam, tau = two_i.default_theta
    return (mu, phi, beta, lam, (n - 1) * tau)


def chain_priors(n):
    """two_i's priors, tau's scale times n - 1."""
    p = two_i.priors()
    p["tau"] = LogNormal(s=2.0, scale=(n - 1) * 1.0)
    return p


def chain_case(n, t_steps=288, thin=1, first=None):
    """(spec, host obs, grid, y0) of the n-class chain on the demo data
    (host H, V; ``thin`` and ``first`` as :func:`demo_frame`), y0
    two_i's: S and V from the data, every class 0."""
    snames = chain_snames(n)
    spec = make_spec(adapt_rhs(chain_rhs(n), "jax"), CHAIN_PNAMES, snames,
                     state_summations=chain_summations(n))
    df = format_dataframe(demo_frame(host="H", thin=thin, first=first),
                          snames)
    obs, tf = fit_inputs(spec, df, t_steps)
    y0 = np.zeros(n + 2)
    y0[0] = df.loc["H"].iloc[0]["abundance"]
    y0[-1] = df.loc["V"].iloc[0]["abundance"]
    return spec, obs, tf, y0


def chain_sde_spec(n, sd=0.02):
    """The n-class chain with multiplicative process noise of sd ``sd`` on
    every state (an SDE variant for PMMH)."""
    def noise(t, y, ps):
        return [sd * y[s] for s in range(n + 2)]
    return make_spec(adapt_rhs(chain_rhs(n), "jax"), CHAIN_PNAMES,
                     chain_snames(n), state_summations=chain_summations(n),
                     diffusion=adapt_rhs(noise, "jax"))


def _simulated(model, theta, times, seed, sd=0.1, y0=None):
    """``model``'s states at ``times`` from ``theta`` (scipy LSODA, rtol
    1e-10) with log-normal noise of sd ``sd`` (numpy ``seed``), one frame
    row per state and time."""
    from scipy.integrate import odeint
    f = model.rhs

    def g(y, t):
        out = f(t, torch.as_tensor(y), list(torch.as_tensor(theta)))
        return out.numpy()
    ys = odeint(g, list(model.default_y0 if y0 is None else y0), times,
                rtol=1e-10, atol=1e-12, mxstep=100000)
    rng = np.random.default_rng(seed)
    return pd.concat([pd.DataFrame({
        "organism": name, "time": times,
        "abundance": ys[:, s] * np.exp(sd * rng.normal(size=len(times))),
        "log_sigma": sd}) for s, name in enumerate(model.snames)],
        ignore_index=True)


LV_TIMES = np.linspace(0.0, 50.0, 25)


def lv_frame(seed=13):
    """Lotka-Volterra's prey and predator at 25 times over [0, 50] from
    its default theta and y0, log-normal noise of sd 0.1."""
    return _simulated(lotka_volterra, lotka_volterra.default_theta,
                      LV_TIMES, seed)


CHEMOSTAT_TIMES = np.linspace(0.0, 80.0, 16)


def chemostat_frames(dilutions, seed=11, rin=5.0):
    """One frame per dilution rate d: the chemostat's R and N at 16 times
    over [0, 80] from its defaults at that d (feed ``rin``), log-normal
    noise of sd 0.1, all drawn from one numpy ``seed`` in order."""
    rng_seeds = np.random.default_rng(seed).integers(0, 2 ** 31,
                                                     len(dilutions))
    vmax, Ks, gamma, _, _ = chemostat.default_theta
    return [_simulated(chemostat, (vmax, Ks, gamma, float(d), rin),
                       CHEMOSTAT_TIMES, int(s))
            for d, s in zip(dilutions, rng_seeds)]
