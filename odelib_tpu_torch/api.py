"""Reference-compatible user API: ``ModelFramework`` + ``parameter``.

Counterpart of ``odelib_tpu/api.py`` for the main path: construction from
a dataframe (optionally with a ``diffusion=`` making the model an SDE,
``forcings=`` giving the RHS a fourth argument of time-varying covariates,
and array-valued parameters, one theta slot per entry),
accessors, ``integrate`` (adaptive Dopri5, Kvaerno3/5 or 'auto', with
doses), the fit
statistics of every observation model (censored points scored by Tobit
terms and left out of R^2), the LHS
prescreen, ``fit_survey`` and ``MCMC`` with ``sampler='mh'``,
``'ensemble'``, ``'pt'``, ``'pmmh'``, ``'hmc'`` and ``'amh'``: where
``odelib_tpu`` on a TPU runs its fused kernels, the sampler's CUDA
kernel (MH, Goodman-Weare
ensemble, parallel tempering, particle-marginal MH; the prescreen scored
by the survey kernel; in-kernel priors with ``use_priors=True``, a
calibrated schedule with ``substeps='auto'``), elsewhere the reference's
XLA samplers in torch (``samplers/mh.py``, ``ensemble.py``, ``pt.py``,
``pf.py``, ``hmc.py``, ``amh.py``: any method, prior, observation model
and RHS, any particle count; the prescreen by ``fit_survey``); chains
seeded under the
``sd_fitdistance`` chi cut, the posterior DataFrame and the Fitting
Report. An SDE model (``diffusion=``) also has ``simulate`` (stochastic
paths) and ``tune_particles`` (PMMH's particle count);
``get_chi_sensitivity`` is chi's gradient through the fixed-step solve.
``fit_map``, ``laplace_approximation``, ``fit_advi``,
``profile_likelihood``, ``model_evidence`` and the model-criticism tools
(``information_criteria``, ``posterior_predictive``, ``prior_predictive``,
``diagnostics``, ``sbc``, ``power_scale_sensitivity``,
``sobol_sensitivity``, ``local_sensitivity``) come from
:class:`~odelib_tpu_torch.api_inference.InferenceMixin`.

``ModelFramework(device=...)`` picks where everything runs: ``cuda`` by
default, and ``cpu`` only when asked for; without a card the default
raises. On ``cuda`` the kernels run; on ``cpu`` their torch twins do. An
option not ported yet raises ``NotImplementedError`` naming its ROADMAP
item; it is never moved to the twin.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
import warnings

import numpy as np
import pandas as pd
import torch

from . import data as _data
from . import dispatch as _dispatch
from . import distributions as _dist
from . import stats as tstats
from .api_inference import InferenceMixin
from .model import (dose_matrix, make_spec, state_func, state_jac,
                    traces)
from .ops.integrate import odeint_grid
from .rhs import adapt_rhs
from .samplers.lhs import sample_lhs
from .samplers.mh import survey as _survey
from .utils.profiling import StageTimer
from .utils.profiling import get_logger as _get_logger


def rawstats(pdseries):
    """Raw median and standard deviation of a posterior series."""
    m, s = tstats.rawstats(np.asarray(pdseries, float))
    return float(m), float(s)


def _norm_substeps_arg(substeps):
    """Validate/normalize a user substeps setting: positive int, the string
    'auto' (a calibrated per-interval schedule, resolved inside MCMC), or
    an explicit per-interval schedule (stored as a hashable tuple)."""
    if isinstance(substeps, str):
        if substeps != "auto":
            raise ValueError(
                f"substeps must be an int, 'auto', or a per-interval "
                f"sequence; got {substeps!r}")
        return "auto"
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


_SAMPLERS = ("mh", "hmc", "pt", "ensemble", "amh", "pmmh")
_FIXED = ("dopri5", "rk4", "kvaerno3")


class ModelFramework(InferenceMixin):
    """Bayesian ODE fitting framework (reference API) on PyTorch.

    Same construction and semantics as ``odelib_tpu.ModelFramework``
    (``obs_model`` 'lognormal', 'student_t', 'poisson' or 'negbinom' with
    ``obs_param``; a ``censored`` dataframe column of detection limits,
    scored by Tobit terms; bolus ``dose_events``; ``forcings``, the
    reference's linear, hold or cubic covariate tables, which the RHS
    takes as a fourth argument, a dict of their values at t; array-valued
    parameters, whose non-zero entries walk and zero entries stay 0),
    plus ``device``: where tensors live and
    kernels run (default ``cuda``; ``cpu`` runs the kernels' torch twins
    and must be asked for). Solver
    knobs: ``method`` 'dopri5' | 'rk4' | 'kvaerno3' (the fixed-step
    kernels' stepper) or 'kvaerno5' | 'auto' (adaptive: ``integrate`` and
    the scan samplers), ``rtol``/``atol``/``max_steps`` for the adaptive
    solves (``integrate``, the prescreen and chains of the scan samplers),
    ``substeps`` (int or per-interval schedule) for the kernels.
    ``diffusion`` is the diagonal process noise ``g`` of
    ``dy = f dt + g dW``, with the RHS's signature convention: the model is
    then fitted with
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
        if device is None and not torch.cuda.is_available():
            raise RuntimeError(
                "ModelFramework runs on a CUDA device by default and found "
                "none (torch.cuda.is_available() is False); pass "
                "device='cpu' to run the kernels' torch twins on the CPU")
        self.device = torch.device("cuda" if device is None else device)
        self._pnames = tuple(parameter_names)
        self._snames = tuple(state_names)
        self._model = ODE
        self._solver = dict(method=method, rtol=float(rtol), atol=float(atol),
                            max_steps=int(max_steps),
                            substeps=_norm_substeps_arg(substeps))
        self.parameters = {el: None for el in self._pnames}
        self.istates = {el: 0 for el in self._snames}
        self.random_seed = random_seed
        self._state_summations = state_summations
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
                _data.compact_observation_grid(
                    obs, self.times, extra_times=[
                        t for t, _, _ in self._spec.dose_events or ()])
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
        self._refresh_pshapes()

    def _refresh_pshapes(self):
        """Rebuild the spec when a parameter's value shape changes (an
        array parameter is one theta slot per entry); the RHS is reused."""
        shapes = tuple(
            tuple(np.shape(self.parameters[p].val))
            if self.parameters[p] is not None else () for p in self._pnames)
        if shapes != self._spec.pshapes:
            sp = self._spec
            self._spec = make_spec(
                sp.rhs, self._pnames, self._snames, self._state_summations,
                pshapes=shapes, obs_model=sp.obs_model,
                obs_param=sp.obs_param or None, dose_events=sp.dose_events,
                forcings=sp.forcings, diffusion=sp.diffusion)

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

    def _templates(self):
        """Per parameter: the flat current value of an array parameter
        (zero entries never walk and draw no LHS dimension, the
        reference's convention), None for a scalar."""
        out = []
        for p, shp in zip(self._pnames, self._spec.pshapes):
            par = self.parameters[p]
            out.append(None if not shp else np.ravel(np.asarray(
                par.val if par is not None else np.zeros(shp), float)))
        return out

    def _pin_zero_templates(self, mask):
        """Zero the flat-mask entries of array parameters whose template
        value is 0 (``odelib_tpu``'s ``_pin_zero_templates``)."""
        for off, tmpl in zip(self._spec.theta_offsets, self._templates()):
            if tmpl is not None:
                sl = slice(off, off + tmpl.size)
                mask[sl] = np.where(tmpl != 0, mask[sl], 0.0)
        return mask

    def _walk_mask(self, static_parameters=()):
        """Flat walk mask: 1.0 for walked slots; 0.0 for static
        parameters' slots and zero-template entries of array parameters."""
        offsets = self._spec.theta_offsets
        mask = np.ones(self._spec.theta_size)
        for p in static_parameters:
            i = self._pnames.index(p)
            shp = self._spec.pshapes[i]
            mask[offsets[i]:offsets[i] + (int(np.prod(shp)) if shp
                                          else 1)] = 0.0
        return self._pin_zero_templates(mask)

    def _slot_priors(self):
        """The prior of every theta slot: an array parameter's per
        non-zero entry, None on a zero-template entry (it never walks, and
        its log density would be -inf on both sides of the ratio)."""
        out = []
        for p, tmpl in zip(self._pnames, self._templates()):
            par = self.parameters[p]
            d = par.tdist if par is not None else None
            if tmpl is None:
                out.append(d)
            else:
                out.extend(d if v != 0 else None for v in tmpl)
        return out

    def _prior_nonzero_masks(self):
        """Per parameter: an array parameter's non-zero template mask (a
        tuple of 0/1), None for a scalar (``odelib_tpu``'s
        ``_prior_nonzero_masks``). Zero entries never walk and their
        positive-support log density is -inf: they stay out of a prior
        sum."""
        masks = []
        for p, shp in zip(self._pnames, self._spec.pshapes):
            if not shp:
                masks.append(None)
                continue
            par = self.parameters[p]
            tmpl = np.ravel(np.asarray(
                par.val if par is not None else np.zeros(shp)))
            masks.append(tuple(1 if v != 0 else 0 for v in tmpl))
        return tuple(masks)

    def _prior_logpdf(self, skip=()):
        """``prior_logpdf(theta (N, P)) -> (N,)`` for the scan samplers
        (``odelib_tpu``'s ``_prior_logpdf_for``): each parameter's prior
        log density, summed over its entries, added in parameter order; an
        array parameter's zero-template entries are left out (they never
        walk, and their log density is -inf on both sides of the ratio).
        The parameters named in ``skip`` (static ones, held fixed) and
        those without a prior contribute nothing. Any family:
        DiscreteNormal and array hyperparameters too."""
        spec = self._spec
        parts = []
        for p, tmpl in zip(self._pnames, self._templates()):
            par = self.parameters[p]
            d = par.tdist if par is not None and p not in skip else None
            parts.append(None if d is None else
                         (d, None if tmpl is None else tmpl != 0))

        def prior_logpdf(theta):
            lead = tuple(theta.shape[:-1])
            tot = torch.zeros(lead, dtype=theta.dtype, device=theta.device)
            for part, v in zip(parts, spec.unpack_theta(theta)):
                if part is None:
                    continue
                d, keep = part
                lp = d.logpdf(v)
                if keep is not None:
                    k = torch.as_tensor(keep.reshape(v.shape[len(lead):]),
                                        device=v.device)
                    lp = torch.where(k, lp, 0.0).reshape(lead + (-1,)).sum(-1)
                tot = tot + lp
            return tot
        return prior_logpdf

    def _theta_from_df(self, df: pd.DataFrame):
        """(N, P) float64 thetas from a parameter dataframe (array
        parameters' cells hold their arrays), missing columns filled with
        the current values."""
        cols = []
        for p, shp in zip(self._pnames, self._spec.pshapes):
            if p in df and not shp:
                cols.append(np.asarray(df[p].to_numpy(), float)[:, None])
            elif p in df and len(df):
                cols.append(np.stack([np.ravel(np.asarray(v, float))
                                      for v in df[p].to_numpy()]))
            else:
                v = np.ravel(np.asarray(self.parameters[p].val, float))
                cols.append(np.tile(v, (len(df), 1)))
        return np.concatenate(cols, axis=1)

    def _solver_args(self, overrides, n_intervals=None, keep_auto=False):
        s = dict(self._solver)
        s.update({k: _norm_substeps_arg(v) if k == "substeps" else v
                  for k, v in overrides.items() if k in self._SOLVER_KEYS})
        unknown = set(overrides) - set(self._SOLVER_KEYS)
        if unknown:
            raise TypeError(f"unexpected solver keyword(s) {sorted(unknown)}")
        sub = s["substeps"]
        if not keep_auto:
            sub = self._resolve_substeps(sub, n_intervals)
        return s["method"], s["rtol"], s["atol"], s["max_steps"], sub

    def _resolve_substeps(self, substeps, n_intervals=None):
        """Concrete substeps for a compute path: 'auto' resolves to the
        MCMC-calibrated schedule when its length matches this grid (MCMC
        calibrates on the compact fit grid), else to the uniform default 4;
        explicit schedules are length-checked against the grid."""
        if substeps == "auto":
            sched = getattr(self, "_auto_schedule", None)
            if sched is not None and (n_intervals is None
                                      or len(sched) == n_intervals):
                return sched
            return 4
        if (isinstance(substeps, tuple) and n_intervals is not None
                and len(substeps) != n_intervals):
            raise ValueError(
                f"substeps schedule has {len(substeps)} entries but this "
                f"integration grid has {n_intervals} intervals")
        return substeps

    # -- integration -------------------------------------------------------
    def integrate(self, inits=None, parameters=None, predict_obs=False,
                  as_dataframe=True, sum_subpopulations=True, route="auto",
                  **solver_kw):
        """Adaptive solve on ``self.times`` in float64 on the framework's
        device with the configured method (Dopri5, also for 'rk4';
        'kvaerno3', 'kvaerno5' or 'auto'), with the model's doses
        (pre-dose values at the dose times; ``route`` is accepted and
        ignored)."""
        initials = self.get_inits() if inits is None \
            else np.asarray(inits, float)
        if parameters is None:
            theta = self._current_theta()
        else:
            if isinstance(parameters, tuple) and len(parameters) == 1:
                parameters = parameters[0]
            theta = self._spec.pack_theta(list(parameters))
        method, rtol, atol, max_steps, _ = self._solver_args(solver_kw)
        th = torch.as_tensor(theta, dtype=torch.float64, device=self.device)
        sol = odeint_grid(
            state_func(self._spec),
            torch.as_tensor(initials, dtype=torch.float64,
                            device=self.device),
            self.times, list(th), rtol=rtol, atol=atol, max_steps=max_steps,
            method="dopri5" if method == "rk4" else method,
            dose=dose_matrix(self._spec, self.times),
            jac=state_jac(self._spec))
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

    def simulate(self, n_paths=1, inits=None, parameters=None, seed=None,
                 sde_method="euler", sde_substeps=4, sum_subpopulations=True,
                 as_dataframe=True):
        """Stochastic forward simulation: ``n_paths`` independent paths of
        the model's SDE (it needs ``diffusion=``) on ``self.times``, every
        path a lane of one fixed-grid Euler-Maruyama or Milstein loop
        (:func:`~odelib_tpu_torch.model.sdeint_theta`) on the framework's
        device in float64. Path ``i`` uses ``fold_in(PRNGKey(seed), i)``
        (``seed`` defaults to ``random_seed``), so it does not depend on
        ``n_paths``, and equals ``odelib_tpu``'s path for that key.
        Returns a tidy DataFrame of the (post-summation, with
        ``sum_subpopulations``) state columns plus ``time`` and ``path#``,
        or the ``(n_paths, T, S)`` array with ``as_dataframe=False``. A
        diverged path is NaN from its failure on."""
        if self._spec.diffusion is None:
            raise ValueError(
                "simulate() needs a stochastic model — construct the "
                "ModelFramework with diffusion=g (same signature "
                "convention as the ODE, returning per-state noise "
                "intensities)")
        from . import random as jr
        from .model import sdeint_theta
        initials = self.get_inits() if inits is None \
            else np.asarray(inits, float)
        if parameters is None:
            theta = self._current_theta()
        else:
            if isinstance(parameters, tuple) and len(parameters) == 1:
                parameters = parameters[0]
            theta = self._spec.pack_theta(list(parameters))
        base = jr.PRNGKey(self.random_seed if seed is None else int(seed),
                          device=self.device)
        keys = jr.fold_in(base, torch.arange(int(n_paths),
                                             device=self.device))
        th = torch.as_tensor(np.asarray(theta, np.float64),
                             device=self.device)
        ys = sdeint_theta(self._spec, th.expand(int(n_paths), -1),
                          initials, self.times, keys,
                          substeps=int(sde_substeps), method=str(sde_method))
        mod = ys.cpu().numpy()                    # (n_paths, T, S_raw)
        if sum_subpopulations and self._spec.sum_matrix is not None:
            mod = mod @ np.asarray(self._spec.sum_matrix)
        if not as_dataframe:
            return mod
        snames = self.get_snames(after_summation=sum_subpopulations)
        n, T = mod.shape[:2]
        df = pd.DataFrame(mod.reshape(n * T, -1), columns=snames)
        df["time"] = np.tile(np.asarray(self.times, float), n)
        df["path#"] = np.repeat(np.arange(n, dtype=np.int64), T)
        return df

    def tune_particles(self, theta=None, pilot_particles=64, n_reps=32,
                       target_var=1.2, sde_substeps=4, sde_method="euler",
                       seed=None, print_report=True):
        """Recommend ``n_particles`` for ``MCMC(sampler='pmmh')`` by the
        var(log-likelihood) rule (:func:`~odelib_tpu_torch.samplers.pf.
        tune_particles`): ``n_reps`` independent ``pilot_particles``
        filters at ``theta`` (default the current parameter values), keyed
        from ``PRNGKey(seed)`` (default ``random_seed``). Returns
        ``(n_particles, loglik_var)`` and prints a one-line report."""
        from . import random as jr
        from .samplers.pf import tune_particles as _tune
        if self._spec.diffusion is None:
            raise ValueError(
                "tune_particles requires a stochastic model — construct "
                "the framework with diffusion=... (deterministic fits "
                "have no particle filter)")
        if theta is None:
            theta = np.asarray(self._current_theta(), float)
        key = jr.PRNGKey(self.random_seed if seed is None else int(seed),
                         device=self.device)
        k, v = _tune(self._spec, self._obsdata_fit_host,
                     np.asarray(self._times_fit, float),
                     np.asarray(self.get_inits(), float),
                     torch.as_tensor(np.asarray(theta, np.float64),
                                     device=self.device), key,
                     pilot_particles=int(pilot_particles),
                     n_reps=int(n_reps), target_var=float(target_var),
                     substeps=int(sde_substeps),
                     sde_method=str(sde_method))
        if print_report:
            print(f"tune_particles: var(log-lik) = {v:.2f} at "
                  f"K={pilot_particles} -> recommended n_particles = {k} "
                  f"(target var {target_var})")
        return k, v

    # -- goodness of fit ---------------------------------------------------
    def _obs_censor_dict(self):
        """Per-state censoring flags of the dataframe's 'censored' column,
        or {} when nothing is censored."""
        if self.df is None:
            return {}
        return _data.censor_by_state(self.df, dict.fromkeys(self.df.index))

    def get_chi(self, mod_dict):
        """The model's observation score of predictions ``mod_dict``
        (state -> values at its observation times), censored points by
        their Tobit terms."""
        O, C, S, cen = [], [], [], []
        cdict = self._obs_censor_dict()
        for sname in mod_dict:
            O.append(self._obs_logabundance[sname])
            C.append(np.asarray(mod_dict[sname], float))
            S.append(self._obs_logsigma[sname])
            cen.append(cdict.get(sname, np.zeros(len(O[-1]), np.int32)))
        O, C, S = np.concatenate(O), np.concatenate(C), np.concatenate(S)
        with np.errstate(divide="ignore", invalid="ignore"):
            logC = np.log(C)
        return float(tstats.obs_negloglik(
            self._spec.obs_model, self._spec.obs_param, O, logC, S,
            np.exp(O), C, censor=np.concatenate(cen) if cdict else None))

    def get_Rsqrd(self, mod_dict):
        """R^2 of predictions ``mod_dict`` over the exact (uncensored)
        observations."""
        cdict = self._obs_censor_dict()
        abundance, model = {}, {}
        for el in self._obs_logabundance:
            keep = cdict[el] == 0 if el in cdict else slice(None)
            abundance[el] = np.exp(self._obs_logabundance[el])[keep]
            if el in mod_dict:
                model[el] = np.asarray(mod_dict[el], float)[keep]
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

    def get_chi_sensitivity(self, parameters=None, log_scale=True,
                            **solver_kw):
        """Chi's gradient in each parameter at the current (or the given,
        in ``pnames`` order) values: autograd through the fixed-step Dopri5
        solve of the fit grid (the configured ``substeps``), in float64 on
        the framework's device. ``{pname: dchi/dp}`` (an array parameter's
        entries in its shape); with ``log_scale`` (default) the derivative
        in ``log p``, chi's change per e-fold of the parameter."""
        from .model import chi_of_theta
        theta = self._current_theta() if parameters is None \
            else self._spec.pack_theta(list(parameters))
        substeps = self._solver_args(solver_kw, len(self._times_fit) - 1)[4]
        th = torch.as_tensor(np.asarray(theta, np.float64)[None],
                             device=self.device).requires_grad_(True)
        chi = chi_of_theta(self._spec, self._obsdata_fit_host, th,
                           self.get_inits(), self._times_fit,
                           method="fixed_dopri5", substeps=substeps)
        g, = torch.autograd.grad(chi.sum(), th)
        if log_scale:
            g = g * th.detach()
        g = g[0].cpu().numpy()
        out = {}
        for p, off, shp in zip(self._pnames, self._spec.theta_offsets,
                               self._spec.pshapes):
            n = int(np.prod(shp)) if shp else 1
            v = g[off:off + n]
            out[p] = v.reshape(shp) if shp else float(v[0])
        return out

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
            # an array parameter draws one dimension per non-zero entry
            # of its template (array hyperparameters: that entry's)
            dists, dims = [], []
            for par in pdists.values():
                d = par.tdist if isinstance(par, parameter) \
                    else _dist.from_scipy(par)
                tmpl = np.asarray(par.val, float) \
                    if isinstance(par, parameter) and np.ndim(par.val) \
                    else None
                if tmpl is None:
                    dists.append(d)
                    dims.append(None)
                    continue
                nz = np.flatnonzero(tmpl)
                dists.extend(d.element(int(k)) if isinstance(
                    d, _dist.ArrayHyper) else d for k in nz)
                dims.append((tmpl, nz))
            draws = sample_lhs(gen, dists, samples).numpy()
            df = pd.DataFrame()
            off = 0
            for p, dim in zip(pdists, dims):
                if dim is None:
                    df[p] = draws[:, off]
                    off += 1
                    continue
                tmpl, nz = dim
                rows = np.tile(tmpl.ravel(), (samples, 1))
                rows[:, nz] = draws[:, off:off + len(nz)]
                df[p] = list(rows.reshape((samples,) + tmpl.shape))
                off += len(nz)
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
        method, rtol, atol, max_steps, substeps = self._solver_args(
            solver_kw, len(self._times_fit) - 1)
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
             until_rhat=None, until_min_ess=None, max_extensions=8,
             profile=False,
             pallas_interpret=False, pallas_tile_chains=None, route="auto",
             target_accept=None, n_particles=128, sde_method="euler",
             sde_substeps=4, adapt_proposal=None, adapt_rate=0.05,
             n_leapfrog=4, step_size=0.02, mass_adapt=True,
             path_adapt=False, max_leapfrog=256, dense_mass=False,
             adapt_start=50, **solver_kw):
        """Markov Chain Monte Carlo: every chain in one run of the
        sampler's fused kernel (on a CPU framework, its twin), or of the
        reference's scan sampler where ``odelib_tpu`` takes its XLA
        samplers.

        Same signature and posterior DataFrame as ``odelib_tpu``: columns
        pnames..., chi, rsquared, aic, iteration, acceptance_ratio, chain#,
        all_rejected. Samplers:

        * ``'mh'``: random-walk Metropolis-Hastings;
        * ``'ensemble'``: Goodman-Weare stretch moves (``stretch_a``), the
          ``chain_inits`` count being the walker count; in the kernel every
          ``pallas_tile_chains`` walkers (default the JAX package's
          ``pick_tile_chains``) form one independent ensemble, so that
          knob is part of the result there;
        * ``'pt'``: parallel tempering over the ``temperatures`` ladder
          with swaps every ``swap_every`` iterations; the T=1 rung is
          returned and the mean swap acceptance is logged (logger
          ``odelib_tpu_torch``). ``temperatures='auto'`` tunes a geometric
          ladder toward 0.3 swap acceptance first (``tune_ladder`` on the
          scan PT: ``min(chains, 32)`` pilot chains, ``pilot_iters``
          iterations, at most ``ladder_rounds`` rounds, ``n_temps`` rungs;
          the ladder and its acceptance are logged and kept in
          ``last_ladder``);
        * ``'pmmh'``: particle-marginal MH for a model built with
          ``diffusion=``: each proposal is scored by an ``n_particles``
          bootstrap particle filter over the SDE (``sde_method``
          'euler', Euler-Maruyama, or 'milstein', which adds the Milstein
          correction with the same draws; ``sde_substeps`` steps per
          observation interval), chains seeded
          from :meth:`fit_survey` (the drift's chi). During burn-in the
          proposal scale adapts (``adapt_proposal``, default True) toward
          ``target_accept`` (default 0.3) with gain ``adapt_rate``. The
          ``rsquared`` column is NaN;
        * ``'hmc'``: Hamiltonian Monte Carlo through the differentiable
          fixed-step solve (``samplers/hmc.py``; 'rk4' runs rk4, every
          other method fixed-step Dopri5 with ``substeps``): trajectories
          of ``n_leapfrog`` steps of ``step_size``, both adapted during
          burn-in across the chains: the inverse mass from their spread
          (``mass_adapt``; ``dense_mass`` a full covariance), the step
          size toward ``target_accept`` (default 0.65) and, with
          ``path_adapt`` (ChEES), the trajectory length, capped at
          ``max_leapfrog`` steps. One stream drives all chains;
        * ``'amh'``: adaptive Metropolis (``samplers/amh.py``): each
          chain's proposal covariance learnt from its own burn-in states
          after ``adapt_start`` of them, with the configured solver.

        Routing (``odelib_tpu``'s decision on a TPU, the platform test
        left out): ``backend='auto'`` runs the fused kernel when the
        method is dopri5, rk4 or kvaerno3, every prior (with
        ``use_priors``) has an in-kernel form, censored data are lognormal
        or Student-t, the RHS traces into the kernels and, for the
        ensemble, there are at least ``pallas_tile_chains or 1024``
        walkers; otherwise, and always under ``backend='xla'``, it runs
        the scan sampler: MH (``chains[xla]`` in ``last_profile``), the
        ensemble (one ensemble of all walkers, ``chains[ensemble]``) or PT
        (``chains[pt]``), on the framework's device in float64, its
        prescreen :meth:`fit_survey` with the configured solver, draws
        from ``jax.random``'s stream (:mod:`odelib_tpu_torch.random`), so
        a run equals ``odelib_tpu``'s XLA sampler on the same starts. An
        RHS the tracer refuses is called per lane through
        ``torch.func.vmap`` there (Python control flow on a value raises).
        ``backend='pallas'`` runs the kernel: a prior without an in-kernel
        form or an RHS that does not trace raise ``ValueError``, another
        method warns that it is not honoured. PMMH runs its kernel when
        the kernel takes the run (Euler-Maruyama or Milstein, 8 to 512
        particles in multiples of 8, a drift and diffusion that trace,
        in-kernel priors, an int ``sde_substeps``), else and under
        ``backend='xla'`` the reference's XLA particle filter
        (:func:`~odelib_tpu_torch.samplers.pf.pmmh`, float64, the scan
        samplers' keys); ``backend='pallas'`` on a run the kernel cannot
        take raises ``ValueError``. The arm is logged. HMC and adaptive
        Metropolis have no kernel, in ``odelib_tpu`` as here: they run
        their scan samplers (``chains[hmc]``, ``chains[amh]``) under
        'auto' and 'xla', and ``backend='pallas'`` raises ``ValueError``.

        ``use_priors=True`` adds the parameters' log priors to every
        sampler's acceptance (in the kernels the ten families of
        :mod:`~odelib_tpu_torch.ops.priors`; the scan samplers take any
        family). ``substeps='auto'`` (here or on the framework) calibrates
        the kernels' per-interval schedule from this run's seeding draws
        with the adaptive solver (:mod:`~odelib_tpu_torch.ops.schedule`),
        caches it as ``_auto_schedule`` and logs it; the prescreen uses the
        last calibrated schedule, or 4 on the first call.

        ``checkpoint_every`` runs the chains in chunks of that many
        proposals (the kernel's, the scan MH's, PT's, PMMH's or HMC's) and
        persists the chain state and records after each to
        ``<checkpoint_path>.progress`` (the port's own format: a file
        ``odelib_tpu`` wrote fails the resume); ``resume_from`` (with the
        same ``checkpoint_every``) continues a killed run from such a file,
        bitwise the uninterrupted run's posterior, and raises
        ``ValueError`` for one written by a different configuration, data
        or priors; the scan ensemble and adaptive Metropolis warn and run
        without.
        ``checkpoint_path`` alone saves the posterior there
        (:func:`~odelib_tpu_torch.utils.checkpoint.save_posterior`).
        ``until_rhat``/``until_min_ess`` (``sampler='mh'``, not with
        checkpointing): after the run, while the pooled posterior's worst
        split-R-hat or least ESS over the walked parameters misses the
        target, every chain continues from its last state for another
        ``iterations_per_chain`` proposals (a fresh stream, no burn-in),
        at most ``max_extensions`` times (then a warning); the iteration
        column continues and the acceptance ratios stay exact running
        ratios.

        ``cpu_cores``, ``route`` and ``pallas_interpret`` are accepted and
        ignored, and so is ``pallas_tile_chains`` for 'mh' and 'pt'.
        ``profile=True`` records each stage's wall seconds in
        ``last_profile`` (the chains' stage as ``chains[<arm>]``), with a
        device synchronize at each stage boundary, and logs them as the
        "stage timings:" report (:class:`~odelib_tpu_torch.utils.
        StageTimer`). ``method='kvaerno3'``
        runs the kernels' implicit fixed-step Kvaerno3 (the stiff path;
        ``substeps='auto'`` calibrates it with Kvaerno5).
        """
        until = until_rhat is not None or until_min_ess is not None
        if until and sampler != "mh":
            raise ValueError(
                "until_rhat/until_min_ess run-length extension is supported "
                "for sampler='mh'")
        if until and (checkpoint_every is not None
                      or resume_from is not None):
            raise ValueError(
                "until_rhat/until_min_ess cannot be combined with "
                "checkpointing (the extension count is data-dependent)")
        if sampler not in _SAMPLERS:
            raise ValueError(f"sampler must be 'mh', 'hmc', 'pt', "
                             f"'ensemble', 'amh' or 'pmmh', got {sampler!r}")
        if backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"backend must be 'auto', 'pallas' or 'xla', "
                             f"got {backend!r}")
        tune = sampler == "pt" and isinstance(temperatures, str)
        if tune and temperatures != "auto":
            raise ValueError("temperatures must be a ladder tuple or 'auto'")
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
        n_req = chain_inits if isinstance(chain_inits, int) \
            else len(chain_inits)
        n_fit_intervals = len(self._times_fit) - 1
        method, rtol, atol, max_steps, substeps = self._solver_args(
            solver_kw, n_fit_intervals, keep_auto=True)
        auto_substeps = substeps == "auto"
        if auto_substeps:
            # the prescreen runs on the last calibrated schedule (or the
            # uniform default on the first call); the chains' schedule is
            # calibrated below from this run's own seeding draws
            substeps = self._resolve_substeps("auto", n_fit_intervals)
        # per slot: an array parameter's prior on each non-zero entry
        from .ops.priors import kernel_priors_supported, require_kernel_priors
        slot_priors = tuple(self._slot_priors()) if use_priors else None
        if sampler == "pmmh":
            # the pmmh arm picks the fused kernel or the XLA particle
            # filter itself (dispatch.run_pmmh); 'pallas'/'xla' force it
            priors = slot_priors if use_priors and kernel_priors_supported(
                slot_priors) else None
            arm = "pallas"
        elif sampler in ("hmc", "amh"):
            # no kernel: the scan sampler under 'auto' and 'xla'
            if backend == "pallas":
                raise ValueError(f"sampler={sampler!r} runs on the XLA "
                                 "backend; drop backend='pallas'")
            priors, arm = None, sampler
            _dispatch.require_batched(self._spec, self._current_theta()[
                None], self.get_inits(), self._times_fit[0])
        else:
            # odelib_tpu's TPU decision: the fused kernel when the method
            # is a fixed-step one, every prior has an in-kernel form,
            # censored data are lognormal or Student-t, the RHS traces and
            # an ensemble fills a tile of walkers; else the scan sampler
            priors = slot_priors if use_priors and kernel_priors_supported(
                slot_priors) else None
            fused_ok = (
                method in _FIXED and (not use_priors or priors is not None)
                and (self._obsdata_fit_host is None
                     or self._obsdata_fit_host.censor is None
                     or self._spec.obs_model in ("lognormal", "student_t"))
                and traces(self._spec)
                and (sampler != "ensemble"
                     or n_req >= int(pallas_tile_chains or 1024)))
            if backend == "pallas":
                if use_priors:
                    priors = require_kernel_priors(slot_priors)
                _dispatch.require_kernel_rhs(self._spec)
                if method not in _FIXED:
                    warnings.warn(
                        f"backend='pallas' integrates fixed-step dopri5/rk4/"
                        f"kvaerno3; the configured method={method!r} is not "
                        "honored there")
                arm = "pallas"
            else:
                arm = "pallas" if backend == "auto" and fused_ok else "xla"
            if arm == "xla":
                if sampler != "mh":
                    arm = sampler
                _dispatch.require_batched(self._spec, self._current_theta()[
                    None], self.get_inits(), self._times_fit[0])
        if arm in ("ensemble", "amh") and checkpoint_every is not None:
            warnings.warn("checkpoint_every is supported on the fused "
                          "MH/ensemble/PT kernels and the scan MH, HMC, "
                          f"PMMH and PT samplers; running sampler={sampler!r}"
                          " without periodic checkpoints")
            checkpoint_every = None
        if resume_from is not None and checkpoint_every is None:
            raise ValueError(
                "resume_from requires checkpoint_every (and "
                "checkpoint_path) — restate the checkpointing "
                "configuration the run was started with")
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
            if arm != "pallas" or sampler == "pmmh":
                # the scan samplers' own solver; for 'pmmh' the drift's
                # chi, a prescreen of start points, not part of the
                # particle filter's target
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
        if auto_substeps and method in _FIXED:
            # substeps='auto': the adaptive solver over this run's seeding
            # draws sets the fixed schedule (ops/schedule.py), cached on the
            # instance for later surveys
            from .ops.schedule import calibrate_substeps, schedule_cost
            substeps = calibrate_substeps(
                self._spec, self.get_inits(), self._times_fit, theta0,
                rtol=rtol, atol=atol,
                method="kvaerno5" if method == "kvaerno3" else "dopri5",
                max_steps=max_steps, device=self.device)
            self._auto_schedule = substeps
            _get_logger().info(
                "substeps='auto': calibrated schedule %s (total %d RHS "
                "steps/solve vs %d at uniform 4)", list(substeps),
                schedule_cost(substeps), 4 * n_fit_intervals)
            stage_done("calibration")
        mask = self._walk_mask(static_parameters)
        prior_logpdf = self._prior_logpdf() if use_priors else None
        if tune:
            # temperatures='auto': a geometric ladder tuned toward 0.3
            # swap acceptance per proposal by pilot runs of the scan PT
            # (samplers/pt.py tune_ladder) on the first min(chains, 32)
            # seeds; the production run then goes where routing sends it
            from . import random as jr
            from .samplers.pt import tune_ladder
            pilot_n = min(n_chains, 32)
            temperatures, tuned_acc = tune_ladder(
                self._spec, self._obsdata_fit_host, self._times_fit,
                self.get_inits(), torch.as_tensor(
                    np.asarray(theta0, np.float64)[:pilot_n],
                    device=self.device),
                jr.split(jr.PRNGKey(int(self.random_seed) ^ 0x7A5,
                                    device=self.device), pilot_n),
                n_temps=int(n_temps), target_swap=0.3,
                pilot_iters=int(pilot_iters), max_rounds=int(ladder_rounds),
                walk_mask=mask, rwalk_std=rwalk_std,
                prior_logpdf=prior_logpdf, use_priors=use_priors,
                swap_every=swap_every, method=method, rtol=rtol, atol=atol,
                max_steps=max_steps, substeps=substeps)
            self.last_ladder = (temperatures, tuned_acc)
            _get_logger().info(
                "temperatures='auto': tuned geometric ladder %s (pilot mean "
                "swap acceptance %.3f)", [round(t, 3) for t in temperatures],
                tuned_acc)
            stage_done("ladder")
        # a digest of the data, solver and (with use_priors) priors in the
        # resume signature: a resume against edited data must fail
        config_token = "" if checkpoint_every is None else \
            self._stable_config_token(method, substeps, use_priors)
        cfg = _dispatch.RunConfig(
            nits=nits, burnin=burnin,
            mask=mask, rwalk_std=rwalk_std,
            method=method, substeps=substeps,
            tile_chains=(None if pallas_tile_chains is None
                         else int(pallas_tile_chains)),
            temperatures=tuple(temperatures), swap_every=int(swap_every),
            stretch_a=float(stretch_a), priors=priors,
            n_particles=int(n_particles), sde_substeps=sde_substeps,
            sde_method=str(sde_method),
            pmmh_mode=backend if backend in ("pallas", "xla") else "auto",
            adapt_proposal=(sampler == "pmmh" if adapt_proposal is None
                            else bool(adapt_proposal)),
            adapt_rate=float(adapt_rate),
            # HMC's dual averaging aims at the gradient samplers' 0.65,
            # PMMH's proposal adaptation at 0.3
            target_accept=(0.3 if sampler == "pmmh" else 0.65)
            if target_accept is None else float(target_accept),
            n_leapfrog=int(n_leapfrog), step_size=float(step_size),
            mass_adapt=bool(mass_adapt), path_adapt=bool(path_adapt),
            max_leapfrog=int(max_leapfrog), dense_mass=bool(dense_mass),
            adapt_start=int(adapt_start),
            checkpoint_every=checkpoint_every,
            checkpoint_path=checkpoint_path, resume_from=resume_from,
            config_token=config_token, rtol=rtol, atol=atol,
            max_steps=max_steps, prior_logpdf=prior_logpdf)
        out = _dispatch.dispatch(self, sampler, theta0, cfg, arm, n_chains)
        if until:
            def run_more(th_last, salt):
                more = dataclasses.replace(cfg, burnin=0)
                if arm == "pallas":
                    return _dispatch.run_fused_mh(self, th_last, dataclasses.
                                                  replace(more, seed_offset=
                                                          104729 * salt))
                return _dispatch.run_scan_mh(
                    self, th_last, dataclasses.replace(more, key_salt=salt),
                    len(th_last))
            from .utils.diagnostics import extend_until
            out = extend_until(
                out, run_more, nits=nits, mask=mask, until_rhat=until_rhat,
                until_min_ess=until_min_ess,
                max_extensions=int(max_extensions))
        stage_done(f"chains[{'pmmh' if sampler == 'pmmh' else arm}]")
        posterior = self._posterior_to_df(out, n_chains, static_parameters)
        if checkpoint_path:
            from .utils.checkpoint import save_posterior
            save_posterior(checkpoint_path, posterior)
        stage_done("posterior")

        if print_report:
            report = ["\nFitting Report\n==============="]
            for col, shp in zip(self.get_pnames(), self._spec.pshapes):
                if shp:     # per entry of an array parameter
                    vals = np.stack(posterior[col].to_numpy()).reshape(
                        len(posterior), -1).astype(float)
                    med, sd = tstats.rawstats(vals, dim=0)
                    report.append(f"parameter: {col}\n\tmedian = "
                                  f"{med.numpy()}, Standard deviation = "
                                  f"{sd.numpy()}")
                    continue
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
            timer = StageTimer()
            timer.times.update(stages)
            timer.report()
        return posterior

    def _stable_config_token(self, method, substeps, include_priors=False):
        """A process-stable sha1 of what the chains' target density bakes
        in: the parameter names, method and substeps, the observation
        model, the doses, the initial states, the time grid and the
        observation arrays, and with ``include_priors`` each parameter's
        prior family and hyperparameters (``odelib_tpu``'s
        ``_stable_config_token`` in the port's terms). Part of a
        checkpoint's signature, so a resume against edited data or priors
        raises."""
        h = hashlib.sha1()
        spec = self._spec
        h.update(repr((tuple(spec.pnames), str(method), substeps,
                       spec.obs_model, spec.obs_param,
                       spec.dose_events, spec.pshapes,
                       spec.forcings)).encode())
        h.update(np.asarray(self.get_inits(), float).tobytes())
        h.update(np.asarray(self._times_fit, float).tobytes())
        for leaf in self._obsdata_fit_host:
            if leaf is not None:
                h.update(np.asarray(leaf).tobytes())
        if include_priors:
            from .ops.chunked import digest_priors
            digest_priors(h, self.parameters)
        return h.hexdigest()

    def _posterior_to_df(self, out, n_chains, static_parameters):
        """Records -> the reference's long DataFrame, one block of rows
        per chain (built column-wise; identical to a per-chain concat)."""
        theta = out.theta[:n_chains].cpu().numpy()          # (C, R, P)
        C, R, P = theta.shape
        ar = out.acceptance_ratio[:n_chains].cpu().numpy()
        all_rejected = ar[:, -1] == 0.0 if R else np.zeros(C, bool)
        cols = {}
        for p, off, shp in zip(self._pnames, self._spec.theta_offsets,
                               self._spec.pshapes):
            if shp:     # a cell holds the parameter's array
                n = int(np.prod(shp))
                cols[p] = list(theta[:, :, off:off + n].reshape(
                    (C * R,) + tuple(shp)))
            else:
                cols[p] = theta[:, :, off].reshape(-1)
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
