"""Reference-compatible user API: ``ModelFramework`` + ``parameter``.

Counterpart of ``odelib_tpu/api.py`` for the main path: construction from
a dataframe (optionally with a ``diffusion=`` making the model an SDE),
accessors, ``integrate`` (adaptive Dopri5), the fit statistics, the LHS
prescreen, ``fit_survey`` and ``MCMC`` with ``sampler='mh'``,
``'ensemble'``, ``'pt'`` and ``'pmmh'`` — prescreen scored by the survey
kernel (by ``fit_survey``'s batched solve of the drift for 'pmmh'),
chains seeded under the ``sd_fitdistance`` chi cut, all chains in the
sampler's fused kernel (MH, Goodman-Weare ensemble, parallel tempering,
particle-marginal MH), the posterior DataFrame and the Fitting Report.

``ModelFramework(device=...)`` picks where everything runs: ``cuda`` when
``torch.cuda.is_available()`` and ``cpu`` otherwise. On ``cuda`` the
kernels run; on ``cpu`` their torch twins do. An option the kernels do not
support yet raises ``NotImplementedError`` naming its ROADMAP item; it is
never moved to the twin.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import pandas as pd
import torch

from . import data as _data
from . import dispatch as _dispatch
from . import distributions as _dist
from . import stats as tstats
from .model import make_spec, state_func
from .ops.integrate import odeint_grid
from .rhs import adapt_rhs
from .samplers.lhs import sample_lhs
from .samplers.mh import survey as _survey


def rawstats(pdseries):
    """Raw median and standard deviation of a posterior series."""
    m, s = tstats.rawstats(np.asarray(pdseries, float))
    return float(m), float(s)


def _norm_substeps_arg(substeps):
    if isinstance(substeps, str):
        raise NotImplementedError(
            "substeps='auto' (calibrate_substeps) is not ported yet "
            "(ROADMAP queue 1, item 5)")
    if isinstance(substeps, (int, np.integer)):
        if int(substeps) < 1:
            raise ValueError("substeps must be >= 1")
        return int(substeps)
    sched = tuple(int(v) for v in np.asarray(substeps).ravel())
    if not sched or any(v < 1 for v in sched):
        raise ValueError("substeps schedule entries must be >= 1")
    return sched


class parameter:
    """Parameter value + prior distribution.

    Accepts scipy.stats generators, name strings or
    :mod:`odelib_tpu_torch.distributions` instances as ``stats_gen``; the
    port-side distribution is ``.tdist``."""

    def __init__(self, stats_gen=None, hyperparameters=None, init_value=None,
                 name=None, random_seed=None):
        self.dist = stats_gen
        self.hp = hyperparameters
        self.name = name
        self._rng = np.random.default_rng(random_seed)
        if init_value is not None:
            self.val = np.array(init_value)
        else:
            if stats_gen is None:
                raise ValueError(
                    "You must specify a distribution if not passing a value")
            self.val = np.array(self._host_rvs())

    def _host_rvs(self, size=None):
        if hasattr(self.dist, "rvs") and not isinstance(self.dist,
                                                        _dist.Distribution):
            return self.dist.rvs(**(self.hp or {}), size=size,
                                 random_state=self._rng)
        u = self._rng.random(() if size is None else (size,))
        return self.tdist.ppf(u).numpy()

    @property
    def tdist(self):
        """Port-side distribution, or None when no prior was given."""
        if self.dist is None:
            return None
        return _dist.from_scipy(self.dist, self.hp)

    def has_distribution(self):
        return self.dist is not None


_FUSED_SAMPLERS = ("mh", "ensemble", "pt", "pmmh")
_UNPORTED_SAMPLERS = {
    "hmc": "ROADMAP queue 1, item 16", "amh": "ROADMAP queue 1, item 16"}
# what the reference runs where the port has no kernel arm yet
_XLA_SAMPLER_ITEM = {
    "mh": "the XLA scan sampler is ROADMAP queue 1, item 8",
    "ensemble": "the XLA samplers/ensemble.py is ROADMAP queue 1, item 15",
    "pt": "the XLA samplers/pt.py is ROADMAP queue 1, item 15",
    "pmmh": "the XLA samplers/pf.py is ROADMAP queue 1, item 15"}


class ModelFramework:
    """Bayesian ODE fitting framework (reference API) on PyTorch.

    Same construction and semantics as ``odelib_tpu.ModelFramework`` for
    scalar-parameter models, plus ``device``: where tensors live and
    kernels run (default ``cuda`` when available, else ``cpu``). Solver
    knobs: ``method`` 'dopri5' | 'rk4' (fixed-step kernels), ``rtol``/
    ``atol``/``max_steps`` for the adaptive ``integrate``, ``substeps``
    (int or per-interval schedule) for the kernels. ``diffusion`` is the
    diagonal process noise ``g`` of ``dy = f dt + g dW``, with the RHS's
    signature convention: the model is then fitted with
    ``MCMC(sampler='pmmh')`` (any other sampler warns and fits the drift
    only, as the reference does), and ``integrate`` solves its drift.
    """

    _SOLVER_KEYS = ("method", "rtol", "atol", "max_steps", "substeps")

    def __init__(self, ODE, parameter_names, state_names, dataframe=None,
                 state_summations=None, t_end=5, t_steps=1000, random_seed=0,
                 ode_style="auto", method="dopri5", rtol=1e-6, atol=1e-4,
                 max_steps=4096, substeps=4, obs_model="lognormal",
                 obs_param=None, dose_events=None, forcings=None,
                 diffusion=None, device=None, **kwargs):
        self.device = torch.device(device if device is not None else (
            "cuda" if torch.cuda.is_available() else "cpu"))
        self._pnames = tuple(parameter_names)
        self._snames = tuple(state_names)
        self._model = ODE
        self._solver = dict(method=method, rtol=float(rtol), atol=float(atol),
                            max_steps=int(max_steps),
                            substeps=_norm_substeps_arg(substeps))
        self.parameters = {el: None for el in self._pnames}
        self.istates = {el: 0 for el in self._snames}
        self.random_seed = random_seed
        self._spec = make_spec(adapt_rhs(ODE, ode_style), self._pnames,
                               self._snames, state_summations,
                               obs_model=obs_model, obs_param=obs_param,
                               dose_events=dose_events, forcings=forcings,
                               diffusion=(None if diffusion is None
                                          else adapt_rhs(diffusion,
                                                         ode_style)))
        self._obs_logabundance, self._obs_logsigma = {}, {}
        if isinstance(dataframe, pd.DataFrame):
            self.df = _data.format_dataframe(dataframe.copy(), self._snames)
            self.times = np.linspace(0, max(self.df["time"]), t_steps)
            (self._pred_tindex, self._obs_logabundance,
             self._obs_logsigma) = _data.fit_setup(self.df, self.times)
            obs, _ = _data.build_obsdata_host(self.df, self.times,
                                              self._spec.post_snames)
            self._times_fit, self._obsdata_fit_host = \
                _data.compact_observation_grid(obs, self.times)
        else:
            self.df = None
            self.times = np.linspace(0, t_end, t_steps)
            self._pred_tindex = {}
            self._obsdata_fit_host = self._times_fit = None
        _is, _ps = {}, {}
        if isinstance(self.df, pd.DataFrame):
            _is.update(_data.initial_states_from_df(self.df))
        for el in kwargs:
            if el in self._pnames:
                _ps[el] = kwargs[el]
            elif el in self._snames or el in self._spec.post_snames:
                _is[el] = kwargs[el]
            else:
                raise TypeError(f"unexpected keyword argument {el!r} (not a "
                                f"parameter or state name)")
        self.set_parameters(**_ps)
        self.set_inits(**_is)
        self._pnum = 0
        for p in self.parameters:
            if self.parameters[p] is not None:
                self._pnum += np.count_nonzero(self.parameters[p].val)

    # -- accessors ---------------------------------------------------------
    def get_pnames(self):
        return list(self._pnames)

    def get_snames(self, after_summation=True, predict_obs=False):
        if after_summation and self._spec.sum_matrix is not None:
            return list(self._spec.post_snames)
        elif predict_obs:
            return list(self._pred_tindex.keys())
        return list(self._snames)

    def set_parameters(self, **kwargs):
        pset = set(self._pnames)
        for p, v in kwargs.items():
            if p not in pset:
                raise Exception(
                    f"{p} is an unknown parameter. Acceptable parameters "
                    f"are: {', '.join(self._pnames)}")
            if isinstance(v, parameter):
                self.parameters[p] = v
                if not v.name:
                    v.name = p
            elif self.parameters[p] is not None:
                self.parameters[p].val = np.array(v)
            else:
                self.parameters[p] = parameter(init_value=v, name=p)
            if np.ndim(self.parameters[p].val):
                raise NotImplementedError(
                    f"parameter {p!r} is array-valued; array parameters "
                    "are not ported yet (ROADMAP queue 1, item 13)")

    def set_inits(self, **kwargs):
        s_set, ss_set = set(self._snames), set(self._spec.post_snames)
        for s, v in kwargs.items():
            if s in s_set:
                self.istates[s] = v
            elif s not in ss_set:
                raise Exception(
                    f"{s} is an unknown state variable. Acceptable "
                    f"parameters are: {', '.join(self._snames)}")

    def get_inits(self, as_dict=False):
        if as_dict:
            return self.istates
        return np.array([self.istates[el] for el in self._snames], float)

    # -- theta packing -----------------------------------------------------
    def _current_theta(self):
        vals = [self.parameters[p].val if self.parameters[p] is not None
                else 0.0 for p in self._pnames]
        return self._spec.pack_theta(vals)

    def _walk_mask(self, static_parameters=()):
        """Flat walk mask: 1.0 for walked slots, 0.0 for static ones."""
        mask = np.ones(self._spec.theta_size)
        for p in static_parameters:
            mask[self._pnames.index(p)] = 0.0
        return mask

    def _theta_from_df(self, df: pd.DataFrame):
        """(N, P) float64 thetas from a parameter dataframe, missing
        columns filled with the current values."""
        cols = []
        for p in self._pnames:
            if p in df:
                cols.append(np.asarray(df[p].to_numpy(), float)[:, None])
            else:
                v = float(np.asarray(self.parameters[p].val, float))
                cols.append(np.full((len(df), 1), v))
        return np.concatenate(cols, axis=1)

    def _solver_args(self, overrides):
        s = dict(self._solver)
        s.update({k: _norm_substeps_arg(v) if k == "substeps" else v
                  for k, v in overrides.items() if k in self._SOLVER_KEYS})
        unknown = set(overrides) - set(self._SOLVER_KEYS)
        if unknown:
            raise TypeError(f"unexpected solver keyword(s) {sorted(unknown)}")
        return s["method"], s["rtol"], s["atol"], s["max_steps"], \
            s["substeps"]

    # -- integration -------------------------------------------------------
    def integrate(self, inits=None, parameters=None, predict_obs=False,
                  as_dataframe=True, sum_subpopulations=True, route="auto",
                  **solver_kw):
        """Adaptive Dopri5 solve on ``self.times`` in float64 on the
        framework's device (``route`` is accepted and ignored)."""
        initials = self.get_inits() if inits is None \
            else np.asarray(inits, float)
        if parameters is None:
            theta = self._current_theta()
        else:
            if isinstance(parameters, tuple) and len(parameters) == 1:
                parameters = parameters[0]
            theta = self._spec.pack_theta(list(parameters))
        method, rtol, atol, max_steps, _ = self._solver_args(solver_kw)
        if method not in ("dopri5", "rk4"):
            raise NotImplementedError(
                f"method={method!r}: adaptive Kvaerno/auto are not ported "
                "yet (ROADMAP queue 1, item 14)")
        th = torch.as_tensor(theta, dtype=torch.float64, device=self.device)
        sol = odeint_grid(
            state_func(self._spec),
            torch.as_tensor(initials, dtype=torch.float64,
                            device=self.device),
            self.times, list(th), rtol=rtol, atol=atol, max_steps=max_steps)
        mod = sol.ys.cpu().numpy()
        if sum_subpopulations and self._spec.sum_matrix is not None:
            mod = mod @ np.asarray(self._spec.sum_matrix)
        snames = self.get_snames(after_summation=sum_subpopulations) \
            if sum_subpopulations else self.get_snames(after_summation=False)
        if as_dataframe:
            df = pd.DataFrame(mod)
            df.columns = snames
            df["time"] = self.times
            if predict_obs:
                calc = pd.melt(df[self.get_snames(predict_obs=True)
                                  + ["time"]], id_vars=["time"])
                calc.columns = ["time", "organism", "abundance"]
                calc = calc.set_index("organism")
                return pd.concat(
                    [calc.loc[s].iloc[self._pred_tindex[s]]
                     for s in self.get_snames(predict_obs=True)])
            return df
        if predict_obs:
            return {sname: mod[:, i][self._pred_tindex[sname]]
                    for i, sname in enumerate(snames)
                    if sname in self._pred_tindex}
        return mod

    # -- goodness of fit ---------------------------------------------------
    def get_chi(self, mod_dict):
        O, C, S = [], [], []
        for sname in mod_dict:
            O.append(self._obs_logabundance[sname])
            C.append(np.asarray(mod_dict[sname], float))
            S.append(self._obs_logsigma[sname])
        O, C, S = np.concatenate(O), np.concatenate(C), np.concatenate(S)
        with np.errstate(divide="ignore", invalid="ignore"):
            logC = np.log(C)
        return float(tstats.obs_negloglik(
            self._spec.obs_model, self._spec.obs_param, O, logC, S))

    def get_Rsqrd(self, mod_dict):
        abundance, model = {}, {}
        for el in self._obs_logabundance:
            abundance[el] = np.exp(self._obs_logabundance[el])
            if el in mod_dict:
                model[el] = np.asarray(mod_dict[el], float)
        return float(tstats.Rsqrd(model, abundance))

    def get_AIC(self, chi):
        return float(tstats.AIC(chi, self._pnum))

    def get_fitstats(self, prediction_dict=None):
        if not prediction_dict:
            prediction_dict = self.integrate(predict_obs=True,
                                             as_dataframe=False)
        fs = {"Chi": self.get_chi(prediction_dict),
              "R^2": self.get_Rsqrd(prediction_dict)}
        fs["AIC"] = self.get_AIC(fs["Chi"])
        return fs

    # -- LHS sampling ------------------------------------------------------
    def _lhs_samples(self, samples=100, seed=None, **kwargs):
        """LHS draws from the priors (a ``torch.Generator`` seeded from
        ``random_seed``), static parameters at their current value."""
        pdists, pstatic = {}, {}
        for p in self.parameters:
            if p in kwargs:
                pdists[p] = kwargs[p]
            elif (self.parameters[p] is not None
                  and self.parameters[p].has_distribution()):
                pdists[p] = self.parameters[p]
            else:
                pstatic[p] = (self.parameters[p].val
                              if self.parameters[p] is not None else 0.0)
        gen = torch.Generator().manual_seed(
            int(self.random_seed if seed is None else seed))
        df = pd.DataFrame(index=range(samples))
        if pdists:
            dists = [par.tdist if isinstance(par, parameter)
                     else _dist.from_scipy(par) for par in pdists.values()]
            draws = sample_lhs(gen, dists, samples).numpy()
            df = pd.DataFrame()
            for i, p in enumerate(pdists):
                df[p] = draws[:, i]
        for p in pstatic:
            df[p] = [pstatic[p]] * samples
        return df

    def fit_survey(self, samples=1000, cpu_cores=1, **solver_kw):
        """LHS prior survey -> DataFrame[pnames..., chi]: the draws of
        ``_lhs_samples`` scored in one batched float64 solve on the
        framework's device with the configured solver (adaptive Dopri5, or
        fixed steps for 'rk4'/'fixed_dopri5'). Failed solves give NaN
        chi; ``cpu_cores`` is accepted and ignored."""
        ps = self._lhs_samples(samples)
        thetas = torch.as_tensor(self._theta_from_df(ps),
                                 dtype=torch.float64, device=self.device)
        method, rtol, atol, max_steps, substeps = self._solver_args(solver_kw)
        chis = _survey(self._spec, self._obsdata_fit_host, self._times_fit,
                       self.get_inits(), thetas, method=method, rtol=rtol,
                       atol=atol, max_steps=max_steps, substeps=substeps)
        out = ps[self.get_pnames()].copy()
        out["chi"] = chis.cpu().numpy()
        return out

    # -- MCMC --------------------------------------------------------------
    def MCMC(self, chain_inits=1, iterations_per_chain=1000, cpu_cores=1,
             static_parameters=(), print_report=True, fitsurvey_samples=1000,
             sd_fitdistance=3.0, use_priors=False, rwalk_std=0.05,
             checkpoint_path=None, checkpoint_every=None, resume_from=None,
             backend="auto", burnin=None, sampler="mh",
             temperatures=(1.0, 2.0, 4.0, 8.0), swap_every=1, n_temps=4,
             pilot_iters=150, ladder_rounds=6, stretch_a=2.0,
             until_rhat=None, until_min_ess=None, profile=False,
             pallas_interpret=False, pallas_tile_chains=None, route="auto",
             target_accept=None, n_particles=128, sde_method="euler",
             sde_substeps=4, adapt_proposal=None, adapt_rate=0.05,
             **solver_kw):
        """Markov Chain Monte Carlo: every chain in one run of the
        sampler's fused kernel (on a CPU framework, its twin).

        Same signature and posterior DataFrame as ``odelib_tpu``: columns
        pnames..., chi, rsquared, aic, iteration, acceptance_ratio, chain#,
        all_rejected. Samplers:

        * ``'mh'``: random-walk Metropolis-Hastings, one launch of the MH
          kernel;
        * ``'ensemble'``: Goodman-Weare stretch moves (``stretch_a``), the
          ``chain_inits`` count being the walker count; every
          ``pallas_tile_chains`` walkers (default the JAX package's
          ``pick_tile_chains``) form one independent ensemble, so that
          knob is part of the result here. As in the reference,
          ``backend='auto'`` takes the kernel only with at least
          ``pallas_tile_chains or 1024`` walkers;
        * ``'pt'``: parallel tempering over the ``temperatures`` ladder
          with swaps every ``swap_every`` iterations; the T=1 rung is
          returned and the mean cold-pair swap acceptance is logged
          (logger ``odelib_tpu_torch``);
        * ``'pmmh'``: particle-marginal MH for a model built with
          ``diffusion=``: each proposal is scored by an ``n_particles``
          bootstrap particle filter over the SDE (Euler-Maruyama,
          ``sde_substeps`` steps per observation interval), chains seeded
          from :meth:`fit_survey` (the drift's chi). During burn-in the
          proposal scale adapts (``adapt_proposal``, default True) toward
          ``target_accept`` (default 0.3) with gain ``adapt_rate``.
          ``use_priors=True`` adds the LogNormal/Normal/Uniform priors to
          the acceptance in the kernel. The ``rsquared`` column is NaN.

        ``cpu_cores``, ``route`` and ``pallas_interpret`` are accepted and
        ignored, and so is ``pallas_tile_chains`` for 'mh' and 'pt'.
        ``profile=True`` records each stage's wall seconds in
        ``last_profile``, with a device synchronize at each stage
        boundary. ``backend='pallas'`` runs the fused kernel and warns if
        the configured method is not dopri5/rk4; ``backend='auto'`` raises
        for such a method, since its JAX counterpart takes the XLA sampler
        there. Not ported yet, each raising ``NotImplementedError``: the
        other samplers, ``use_priors=True`` outside 'pmmh', checkpointing,
        ``until_rhat``/``until_min_ess``, ``backend='xla'`` (and what
        ``backend='auto'`` sends to an XLA sampler), ``temperatures=
        'auto'`` (with ``n_temps``/``pilot_iters``/``ladder_rounds``),
        the kvaerno3 kernel stepper and ``sde_method='milstein'``.
        """
        if sampler not in _FUSED_SAMPLERS:
            if sampler not in _UNPORTED_SAMPLERS:
                raise ValueError(f"sampler must be 'mh', 'hmc', 'pt', "
                                 f"'ensemble', 'amh' or 'pmmh', got "
                                 f"{sampler!r}")
            raise NotImplementedError(
                f"sampler={sampler!r} is not ported yet "
                f"({_UNPORTED_SAMPLERS[sampler]})")
        if sampler == "pt" and isinstance(temperatures, str):
            if temperatures != "auto":
                raise ValueError("temperatures must be a ladder tuple or "
                                 "'auto'")
            raise NotImplementedError(
                "temperatures='auto' tunes the ladder with the XLA PT "
                "sampler (tune_ladder), not ported yet (ROADMAP queue 1, "
                "item 15)")
        if sampler == "pmmh" and self._spec.diffusion is None:
            raise ValueError(
                "sampler='pmmh' targets the STOCHASTIC model: construct the "
                "ModelFramework with diffusion=g (process noise); for a "
                "deterministic ODE use sampler='mh'")
        if sampler != "pmmh" and self._spec.diffusion is not None:
            warnings.warn(
                f"MCMC(sampler={sampler!r}) on a model with diffusion= "
                "fits the DRIFT ONLY: the deterministic likelihood "
                "mis-attributes process noise to observation error. Use "
                "sampler='pmmh' for the exact stochastic posterior.")
        priors = None
        if use_priors:
            if sampler != "pmmh":
                raise NotImplementedError(
                    "use_priors=True (in-kernel priors) is ported for "
                    "sampler='pmmh' only (ROADMAP queue 1, item 12)")
            priors = tuple(self.parameters[p].tdist
                           if self.parameters[p] is not None else None
                           for p in self._pnames)
        if sampler == "pmmh":
            if sde_method == "milstein":
                raise NotImplementedError(
                    "sde_method='milstein' needs the diffusion's diagonal "
                    "derivative from the RHS front end, not ported yet "
                    "(ROADMAP queue 1, item 3)")
            if sde_method != "euler":
                raise ValueError("the fused PMMH kernel integrates "
                                 "Euler-Maruyama or Milstein, got "
                                 f"sde_method={sde_method!r}")
            if not isinstance(sde_substeps, (int, np.integer)):
                raise ValueError("sde_substeps must be an int")
        if checkpoint_every is not None or resume_from is not None \
                or checkpoint_path is not None:
            raise NotImplementedError(
                "checkpointing is not ported yet (ROADMAP queue 1, item 11)")
        if until_rhat is not None or until_min_ess is not None:
            raise NotImplementedError(
                "until_rhat/until_min_ess run-length extension is not "
                "ported yet (ROADMAP queue 1, item 11)")
        if backend not in ("auto", "pallas"):
            raise NotImplementedError(
                f"backend={backend!r}: the port runs the fused kernels "
                f"({_XLA_SAMPLER_ITEM[sampler]})")
        n_req = chain_inits if isinstance(chain_inits, int) \
            else len(chain_inits)
        if sampler == "ensemble" and backend == "auto" \
                and n_req < int(pallas_tile_chains or 1024):
            raise NotImplementedError(
                f"{n_req} walkers do not fill an ensemble tile, where "
                "backend='auto' runs the reference's XLA ensemble "
                f"({_XLA_SAMPLER_ITEM['ensemble']}); pass backend='pallas' "
                "to run the fused kernel")
        method, rtol, atol, max_steps, substeps = self._solver_args(
            solver_kw)
        if method == "kvaerno3" and sampler != "pmmh":
            raise NotImplementedError(
                "the kvaerno3 kernel stepper is not ported yet (ROADMAP "
                "queue 1, item 14)")
        if method not in ("dopri5", "rk4") and sampler != "pmmh":
            if backend == "auto":
                raise NotImplementedError(
                    f"method={method!r} runs on the XLA sampler, not "
                    f"ported yet ({_XLA_SAMPLER_ITEM[sampler]}); pass "
                    "backend='pallas' to run fixed-step dopri5 instead")
            warnings.warn(
                f"backend='pallas' integrates fixed-step dopri5/rk4; the "
                f"configured method={method!r} is not honored there")
        nits = iterations_per_chain
        if burnin is None:
            burnin = int(nits / 2)
        static_parameters = list(static_parameters)
        stages, clock = {}, [time.perf_counter()]

        def stage_done(name):
            if profile:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                now = time.perf_counter()
                stages[name] = now - clock[0]
                clock[0] = now
        stepper = _dispatch.fused_stepper(method)

        if isinstance(chain_inits, pd.DataFrame):
            chain_inits = [row.to_dict() for _, row in
                           chain_inits[self.get_pnames()].iterrows()]
        if isinstance(chain_inits, int):
            n_chains = chain_inits
            if sampler == "pmmh":
                # the drift's chi: a prescreen of start points, not part
                # of the particle filter's target
                fitsurvey = self.fit_survey(samples=fitsurvey_samples,
                                            **solver_kw)
            else:
                # the prescreen uses the chains' own integrator, so a
                # seed's chi is finite under the kernel's fixed steps
                from .ops.cuda_mh import survey_fused
                ps = self._lhs_samples(fitsurvey_samples)
                thetas = torch.as_tensor(
                    self._theta_from_df(ps).astype(np.float32),
                    device=self.device)
                chis = survey_fused(self._spec, self._obsdata_fit_host,
                                    self._times_fit, self.get_inits(),
                                    thetas, substeps=substeps,
                                    stepper=stepper)
                chis = chis.cpu().numpy()
                fitsurvey = ps[self.get_pnames()].copy()
                fitsurvey["chi"] = np.where(np.isfinite(chis), chis, np.nan)
            stage_done("survey")
            fitsurvey = fitsurvey.dropna()
            if fitsurvey.empty:
                initps = pd.DataFrame([[]] * n_chains)
                warnings.warn("Pre-sampling of Multidimentional space failed")
            else:
                calc = {s: np.exp(self._obs_logabundance[s]
                                  + sd_fitdistance * self._obs_logsigma[s])
                        for s in self._obs_logabundance}
                cutchi = self.get_chi(calc)
                if (fitsurvey["chi"] < cutchi).sum() == 0:
                    raise ValueError(
                        "Preliminary sampling found no parameter sets which "
                        "meet the minimal threshold \n Try: \n"
                        " 1. Increasing sd_fitdistance \n"
                        " 2. Increasing fitsurvey_samples \n"
                        " 3. Different priors and / or different parameter "
                        "guesses")
                initps = fitsurvey[fitsurvey["chi"] < cutchi].sample(
                    n_chains, replace=True, random_state=self.random_seed)
            theta0 = self._theta_from_df(
                initps if not initps.empty
                else pd.DataFrame(index=range(n_chains)))
        else:
            n_chains = len(chain_inits)
            theta0 = self._theta_from_df(pd.DataFrame(chain_inits))

        stage_done("seeding")
        cfg = _dispatch.RunConfig(
            nits=nits, burnin=burnin,
            mask=self._walk_mask(static_parameters), rwalk_std=rwalk_std,
            method=method, substeps=substeps,
            tile_chains=(None if pallas_tile_chains is None
                         else int(pallas_tile_chains)),
            temperatures=tuple(temperatures), swap_every=int(swap_every),
            stretch_a=float(stretch_a), priors=priors,
            n_particles=int(n_particles), sde_substeps=int(sde_substeps),
            adapt_proposal=(sampler == "pmmh" if adapt_proposal is None
                            else bool(adapt_proposal)),
            adapt_rate=float(adapt_rate),
            target_accept=0.3 if target_accept is None
            else float(target_accept))
        out = _dispatch.dispatch(self, sampler, theta0, cfg)
        stage_done("chains")
        posterior = self._posterior_to_df(out, n_chains, static_parameters)
        stage_done("posterior")

        if print_report:
            report = ["\nFitting Report\n==============="]
            for col in self.get_pnames():
                median, std = rawstats(posterior[col])
                if (median != 0.0) and (std != 0.0):
                    report.append(
                        f"parameter: {col}\n\tmedian = {median:0.3e}, "
                        f"Standard deviation = {std:0.3e}")
            self.set_best_params(posterior)
            mod = self.integrate(predict_obs=True, as_dataframe=False)
            fs = self.get_fitstats(mod)
            report.append("\nMedian parameter fit stats:")
            report.append(f"\tChi = {fs['Chi']:0.3e}\n\tR-squared = "
                          f"{fs['R^2']:0.3e}\n\tAIC = {fs['AIC']:0.3e}")
            print("\n".join(report))
        stage_done("report")
        if profile:
            self.last_profile = stages
        return posterior

    def _posterior_to_df(self, out, n_chains, static_parameters):
        """Records -> the reference's long DataFrame, one block of rows
        per chain (built column-wise; identical to a per-chain concat)."""
        theta = out.theta[:n_chains].cpu().numpy()          # (C, R, P)
        C, R, P = theta.shape
        ar = out.acceptance_ratio[:n_chains].cpu().numpy()
        all_rejected = ar[:, -1] == 0.0 if R else np.zeros(C, bool)
        cols = {p: theta[:, :, i].reshape(-1)
                for i, p in enumerate(self._pnames)}
        for name, rec in (("chi", out.chi), ("rsquared", out.rsquared),
                          ("aic", out.aic)):
            cols[name] = rec[:n_chains].cpu().numpy().reshape(-1)
        cols["iteration"] = np.tile(out.iteration.cpu().numpy(), C)
        cols["acceptance_ratio"] = ar.reshape(-1)
        cols["chain#"] = np.repeat(np.arange(C, dtype=np.int64), R)
        cols["all_rejected"] = np.repeat(all_rejected.astype(bool), R)
        if all_rejected.any():
            warnings.warn(
                f"{int(all_rejected.sum())}/{C} chains never accepted a "
                "proposal; their rows repeat the seed draw and are flagged "
                "all_rejected=True — drop them from pooled posteriors")
        return pd.DataFrame(cols)

    def set_best_params(self, posteriors):
        """Adopt the parameters of the min-chi posterior row (NaN chi
        rows ignored; all-NaN raises)."""
        finite = posteriors[np.isfinite(posteriors.chi.astype(float))]
        if finite.empty:
            raise ValueError(
                "set_best_params: every posterior row has NaN/inf chi "
                "(all integrations failed). Check priors / solver settings.")
        im = finite.loc[finite.chi == finite.chi.min()].index[0]
        bestchain = posteriors.iloc[im]["chain#"]
        posteriors = posteriors[posteriors["chain#"] == bestchain]
        self.set_parameters(
            **posteriors.loc[im][self.get_pnames()].to_dict())
        if self._snames[0] + "0" in self.get_pnames():
            d = posteriors.loc[im][self.get_pnames()].to_dict()
            self.set_inits(**{o: d[o + "0"] for o in self._snames
                              if o + "0" in d})
