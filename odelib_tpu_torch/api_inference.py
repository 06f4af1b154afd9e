"""Point estimates, variational fits, evidence and model criticism: the
inference methods that ``ModelFramework`` mixes in.

Counterpart of ``odelib_tpu/api_inference.py``'s ``InferenceMixin``:
``fit_map`` (multi-start Adam, samplers/optimize.py),
``laplace_approximation`` (the Hessian of the potential by double
backward through the fixed-step solve), ``fit_advi`` (samplers/advi.py),
``profile_likelihood`` (every grid point x start one lane of
``map_fit``), ``model_evidence`` (tempered SMC, samplers/smc.py), WAIC and
PSIS-LOO (``information_criteria``), the posterior and prior predictive
checks, convergence ``diagnostics``, simulation-based calibration
(``sbc``, utils/sbc.py) and the power-scaling, Sobol and local
sensitivities (utils/sensitivity.py). The solves run in float64 on the
framework's device (``device='cpu'`` when the framework was built so);
the host steps (the pseudo-inverse, the chi-square threshold, Pareto
smoothing, the tempering schedule, the predictive noise, the indices) are
numpy and scipy, as in the reference. A method whose math assumes a
deterministic likelihood refuses a stochastic (``diffusion=``) model
unless the caller passes ``drift_only=True``, which warns.
"""
from __future__ import annotations

import warnings

import numpy as np
import pandas as pd
import torch

from . import stats as tstats

_SDE_HINT = "Fit the SDE with MCMC(sampler='pmmh'). "


def _fmt_stats(vals):
    """The report's median and std of a positive sample."""
    m, s = tstats.rawstats(np.asarray(vals, float))
    return float(m), float(s)


class InferenceMixin:
    """Inference methods mixed into
    :class:`~odelib_tpu_torch.api.ModelFramework`."""

    def _require_deterministic(self, what, drift_only, hint=""):
        """A method whose math assumes a deterministic likelihood refuses a
        ``diffusion=`` model, unless opted into the drift-only
        approximation (then it warns): silently fitting the drift skeleton
        misattributes the process noise."""
        if self._spec.diffusion is None:
            return
        if not drift_only:
            raise ValueError(
                f"{what} assumes a deterministic likelihood, but this "
                "model has process noise (diffusion=...): a single "
                "drift trajectory's fit statistic is not the marginal "
                f"likelihood of the SDE. {hint}Pass drift_only=True to "
                "run it anyway on the drift skeleton (the diffusion "
                "term is IGNORED and results do not account for "
                "process noise).")
        warnings.warn(
            f"{what}: drift_only=True on a stochastic model — the "
            "diffusion term is ignored; treat the result as an analysis "
            "of the deterministic skeleton, not of the SDE.")

    def _theta_frame(self, theta):
        """(N, P) flat thetas -> one column per parameter (an array
        parameter's cells its arrays)."""
        theta = np.asarray(theta, float)
        out = {}
        for p, off, shp in zip(self._pnames, self._spec.theta_offsets,
                               self._spec.pshapes):
            n = int(np.prod(shp)) if shp else 1
            col = theta[:, off:off + n]
            out[p] = list(col.reshape((-1,) + shp)) if shp else col[:, 0]
        return pd.DataFrame(out)

    def _fit_args(self, solver_kw):
        """(spec, host obs, fit grid, inits, fixed method, substeps) of the
        gradient fits: 'rk4' stays rk4, every other method runs fixed
        Dopri5."""
        method, _, _, _, substeps = self._solver_args(
            solver_kw, len(self._times_fit) - 1)
        return (self._spec, self._obsdata_fit_host, self._times_fit,
                self.get_inits(),
                "rk4" if method == "rk4" else "fixed_dopri5", substeps)

    def fit_map(self, starts=64, steps=500, learning_rate=0.05,
                use_priors=False, static_parameters=(), set_best=True,
                drift_only=False, **solver_kw) -> pd.DataFrame:
        """Multi-start gradient (Adam) point estimation: maximum likelihood,
        or MAP with ``use_priors=True`` (``odelib_tpu``'s ``fit_map``).

        Draws ``starts`` LHS samples from the priors (the port's
        ``torch.Generator`` LHS), adds the current values as one more
        start, runs ``steps`` Adam iterations from all of them at once
        (each start a lane of one fixed-step solve and its backward pass)
        and returns a DataFrame of the per-start optima (pnames..., chi,
        loss, converged) sorted by chi. ``set_best=True`` pushes the
        winner into the framework.
        """
        self._require_deterministic('fit_map', drift_only, hint=_SDE_HINT)
        from .samplers.optimize import map_fit

        ps = self._lhs_samples(starts)
        theta0 = np.concatenate([self._theta_from_df(ps),
                                 np.asarray(self._current_theta())[None]])
        mask = np.ones(self._spec.theta_size)
        offsets = self._spec.theta_offsets
        for p in static_parameters:
            i = self._pnames.index(p)
            n = int(np.prod(self._spec.pshapes[i])) \
                if self._spec.pshapes[i] else 1
            mask[offsets[i]:offsets[i] + n] = 0.0
        spec, obs, times, y0, method, substeps = self._fit_args(solver_kw)
        res = map_fit(spec, obs, times, y0, theta0, steps=steps,
                      learning_rate=learning_rate, walk_mask=mask,
                      prior_logpdf=self._prior_logpdf() if use_priors
                      else None, use_priors=use_priors, method=method,
                      substeps=substeps, device=self.device)
        df = self._theta_frame(res.theta.cpu().numpy())
        df["chi"] = res.chi.cpu().numpy()
        df["loss"] = res.loss.cpu().numpy()
        df["converged"] = res.converged.cpu().numpy()
        df = df.sort_values("chi").reset_index(drop=True)
        if set_best and np.isfinite(df["chi"].iloc[0]):
            best = df.iloc[0]
            self.set_parameters(**{p: best[p] for p in self._pnames})
        return df

    def laplace_approximation(self, parameters=None, use_priors=False,
                              drift_only=False, **solver_kw):
        """Gaussian (Laplace) posterior approximation around a point
        estimate (``odelib_tpu``'s ``laplace_approximation``): the Hessian
        of U(z) = chi [- log prior] in log-parameter space, by double
        backward through the fixed-step Dopri5 solve (whatever the
        framework's method).

        Run :meth:`fit_map` first (or pass ``parameters``) so the point is
        an optimum. Returns a dict with ``median`` (exp of the mode),
        ``log_std`` (per-parameter posterior std in log space),
        ``cov``/``corr`` (log-space covariance/correlation DataFrames) and
        ``hessian_pd`` (False when the Hessian was not positive definite:
        the pseudo-inverse is used and those stds are unreliable). An
        array parameter contributes one dimension per non-zero template
        entry, labeled ``p[i]``.
        """
        self._require_deterministic('laplace_approximation', drift_only,
                                    hint=_SDE_HINT)
        from .model import chi_of_theta

        if parameters is None:
            theta = np.asarray(self._current_theta(), float)
        else:
            theta = np.asarray(self._spec.pack_theta(list(parameters)),
                               float)
        # free flat slots: everything except zero-template array entries
        offsets = self._spec.theta_offsets
        names, free = [], []
        for i, (p, tmpl) in enumerate(zip(self._pnames, self._templates())):
            if tmpl is None:
                names.append(p)
                free.append(offsets[i])
                continue
            for j, v in enumerate(tmpl):
                if v != 0:
                    names.append(f"{p}[{j}]")
                    free.append(offsets[i] + j)
        free = np.asarray(free)
        spec, obs, times, y0, _, substeps = self._fit_args(solver_kw)
        prior_logpdf = self._prior_logpdf() if use_priors else None
        F, P = len(free), len(theta)
        z0_full = torch.log(torch.as_tensor(
            np.maximum(theta, 1e-300), dtype=torch.float64,
            device=self.device))
        fidx = torch.as_tensor(free, device=self.device)

        def u_of(z_free):
            th = torch.exp(z0_full.expand(len(z_free), P).index_copy(
                1, fidx, z_free))
            u = chi_of_theta(spec, obs, th, y0, times,
                             method="fixed_dopri5", substeps=substeps)
            return u - prior_logpdf(th) if use_priors else u

        # F copies of the point, one a lane: the gradient of sum_j g[j, j]
        # (lane j's j-th partial) is row j of the Hessian in lane j
        with torch.enable_grad():
            zf = z0_full[fidx].expand(F, F).clone().requires_grad_(True)
            g, = torch.autograd.grad(u_of(zf).sum(), zf, create_graph=True)
            H, = torch.autograd.grad(torch.diagonal(g).sum(), zf)
        H = H.cpu().numpy()
        pd_ok = bool(np.all(np.isfinite(H)))
        if pd_ok:
            try:
                np.linalg.cholesky(H)
            except np.linalg.LinAlgError:
                pd_ok = False
        cov = np.linalg.pinv(H) if np.all(np.isfinite(H)) else \
            np.full_like(H, np.nan)
        std = np.sqrt(np.clip(np.diag(cov), 0.0, None))
        with np.errstate(invalid="ignore", divide="ignore"):
            corr = cov / np.outer(std, std)
        theta_free = theta[free]
        return {
            "median": {p: float(v) for p, v in zip(names, theta_free)},
            "log_std": {p: float(s) for p, s in zip(names, std)},
            "cov": pd.DataFrame(cov, index=names, columns=names),
            "corr": pd.DataFrame(corr, index=names, columns=names),
            "hessian_pd": pd_ok,
        }

    def fit_advi(self, steps=800, learning_rate=0.05, n_mc=8,
                 rank="full", draws=1000, use_priors=True,
                 static_parameters=(), resample=False, print_report=True,
                 drift_only=False, **solver_kw) -> pd.DataFrame:
        """Variational (ADVI) posterior (``odelib_tpu``'s ``fit_advi``): a
        Gaussian fitted to the log-parameter posterior by reparameterized
        ELBO ascent through the fixed-step solve, from the current
        parameter values with key ``PRNGKey(random_seed)``, returned as
        ``draws`` posterior draws (pnames..., chi, rsquared, aic).

        ``rank='full'`` learns the full log-space covariance, ``'diag'`` is
        mean-field; ``use_priors`` defaults True (the density the
        prior-aware samplers walk). ``df.attrs['advi']`` holds the ELBO
        trace, the variational mean and Cholesky factor over the free flat
        slots, ``converged``, ``khat`` (Pareto-smoothed importance
        sampling: below 0.7 the smoothed weights ``psis_logw`` reliably
        correct q) and those weights; ``resample=True`` returns rows
        importance-resampled by them. Static parameters and zero-template
        entries are pinned.
        """
        self._require_deterministic('fit_advi', drift_only, hint=_SDE_HINT)
        from .samplers.advi import advi, attach_advi_diagnostics
        if rank not in ("full", "diag"):
            raise ValueError(f"rank must be 'full' or 'diag', got {rank!r}")
        theta0 = np.asarray(self._current_theta(), float)
        mask = self._walk_mask(static_parameters)
        if np.any((theta0 <= 0) & (mask != 0)):
            raise ValueError(
                "fit_advi needs positive current values on every free "
                "dimension (the variational family lives in log space); "
                "set parameters or run fit_map first")
        spec, obs, times, y0, method, substeps = self._fit_args(solver_kw)
        res = advi(spec, obs, times, y0, theta0, steps=steps,
                   learning_rate=learning_rate, n_mc=n_mc,
                   full_rank=(rank == "full"), draws=draws, walk_mask=mask,
                   prior_logpdf=self._prior_logpdf() if use_priors else None,
                   use_priors=use_priors, seed=int(self.random_seed),
                   method=method, substeps=substeps, device=self.device)
        df = self._theta_frame(res.theta.cpu().numpy())
        df["chi"] = res.chi.cpu().numpy()
        df["rsquared"] = res.rsquared.cpu().numpy()
        df["aic"] = res.aic.cpu().numpy()
        df, khat = attach_advi_diagnostics(
            df, res, seed=self.random_seed, resample=resample, label="ADVI")
        if print_report:
            report = ["\nADVI Report (variational posterior)\n"
                      "==================================="]
            for p, shp in zip(self._pnames, self._spec.pshapes):
                vals = df[p].to_numpy()
                if shp:
                    flat = np.stack([np.ravel(np.asarray(v, float))
                                     for v in vals])
                    for j in range(flat.shape[1]):
                        if not np.any(flat[:, j]):
                            continue
                        m, s = _fmt_stats(flat[:, j])
                        report.append(
                            f"parameter: {p}[{j}]\n\tmedian = {m:0.3e}, "
                            f"Standard deviation = {s:0.3e}")
                else:
                    m, s = _fmt_stats(vals)
                    report.append(f"parameter: {p}\n\tmedian = {m:0.3e}, "
                                  f"Standard deviation = {s:0.3e}")
            report.append(f"\nfinal ELBO = {float(res.elbo[-1]):0.4e}, "
                          f"converged = {bool(res.converged)}, "
                          f"khat = {khat:0.3f} "
                          f"({'reliable' if khat < 0.7 else 'UNRELIABLE'})")
            print("\n".join(report))
        return df

    def profile_likelihood(self, parameter_name, p_range=None, points=21,
                           starts=8, steps=400, learning_rate=0.05,
                           confidence=0.95, use_priors=False,
                           print_report=True, drift_only=False,
                           **solver_kw):
        """Profile-likelihood identifiability analysis for one parameter
        (Raue et al. 2009; ``odelib_tpu``'s ``profile_likelihood``): fix
        ``parameter_name`` at each grid value and re-optimize every other
        parameter by :meth:`fit_map`'s Adam, all grid points x starts
        (``starts - 1`` LHS draws and the current values) as lanes of one
        batch.

        ``p_range`` is the grid (default ``points`` values, geometric,
        between the prior's 0.5 and 99.5 % quantiles). Returns a dict:
        ``profile`` (DataFrame value, chi), ``ci`` (the likelihood-ratio
        interval at ``confidence``; a NaN side was not crossed within the
        range), ``threshold`` (min chi + chi2.ppf(confidence, 1) / 2) and
        ``identifiable`` (False when the whole profile stays under it).
        """
        self._require_deterministic(
            'profile_likelihood', drift_only,
            hint="Profile the SDE posterior from MCMC(sampler='pmmh') "
                 "draws instead. ")
        from scipy.stats import chi2 as _chi2

        from .samplers.optimize import map_fit

        if parameter_name not in self._pnames:
            raise ValueError(f"unknown parameter {parameter_name!r}")
        i = self._pnames.index(parameter_name)
        if any(s for s in self._spec.pshapes):
            raise ValueError("profile_likelihood supports scalar "
                             "parameters only")
        if p_range is None:
            par = self.parameters[parameter_name]
            if par is None or not par.has_distribution():
                raise ValueError(f"give p_range: {parameter_name} has no "
                                 "prior to derive one from")
            d = par.tdist
            lo, hi = float(d.ppf(0.005)), float(d.ppf(0.995))
            if not (np.isfinite(lo) and np.isfinite(hi) and lo > 0):
                raise ValueError(f"could not derive a positive range from "
                                 f"the prior of {parameter_name}; give "
                                 "p_range")
            grid = np.geomspace(lo, hi, int(points))
        else:
            grid = np.asarray(p_range, float)
            if grid.ndim != 1 or len(grid) < 3:
                raise ValueError("p_range must be a 1-D grid of >= 3 "
                                 "values")
        G, S = len(grid), int(starts)

        # starts: LHS prior draws + the current theta, each fixed to the
        # grid value in dimension i; the mask freezes that dimension
        ps = self._lhs_samples(max(S - 1, 1))
        th_lhs = np.asarray(self._theta_from_df(ps), float)
        th0 = np.concatenate([th_lhs[:S - 1],
                              np.asarray(self._current_theta(),
                                         float)[None]])
        theta0 = np.tile(th0, (G, 1))                     # (G*S, P)
        theta0[:, i] = np.repeat(grid, S)
        mask = np.ones(self._spec.theta_size)
        mask[self._spec.theta_offsets[i]] = 0.0
        spec, obs, times, y0, method, substeps = self._fit_args(solver_kw)
        res = map_fit(spec, obs, times, y0, theta0, steps=int(steps),
                      learning_rate=float(learning_rate), walk_mask=mask,
                      prior_logpdf=self._prior_logpdf() if use_priors
                      else None, use_priors=use_priors, method=method,
                      substeps=substeps, device=self.device)
        loss = res.loss.cpu().numpy().reshape(G, S)
        loss = np.where(np.isfinite(loss), loss, np.inf)
        prof = loss.min(axis=1)                           # (G,)

        chi_min = float(prof.min())
        delta = float(_chi2.ppf(float(confidence), 1) / 2.0)
        thresh = chi_min + delta

        def crossing(idx_order):
            """The interpolated grid value where the profile crosses the
            threshold, walking out from the minimum; NaN if never crossed
            (a non-finite profile point is unknown, not a crossing)."""
            below = prof <= thresh
            prev = int(np.argmin(prof))
            for j in idx_order:
                if not below[j]:
                    if not np.isfinite(prof[j]):
                        return np.nan
                    # linear interpolation in log-grid space
                    x0, x1 = np.log(grid[prev]), np.log(grid[j])
                    y0_, y1 = prof[prev], prof[j]
                    t = (thresh - y0_) / max(y1 - y0_, 1e-300)
                    return float(np.exp(x0 + t * (x1 - x0)))
                prev = j
            return np.nan

        j_min = int(np.argmin(prof))
        lo_ci = crossing(range(j_min, -1, -1))
        hi_ci = crossing(range(j_min, G))
        identifiable = bool(np.nanmax(prof[np.isfinite(prof)])
                            > thresh) if np.isfinite(prof).any() else False
        out = {
            "profile": pd.DataFrame({"value": grid, "chi": prof}),
            "ci": (lo_ci, hi_ci),
            "threshold": thresh,
            "identifiable": identifiable,
        }
        if print_report:
            def fmt(v):
                return "unbounded" if not np.isfinite(v) else f"{v:0.4g}"
            print(f"profile likelihood [{parameter_name}]: min chi "
                  f"{chi_min:0.4g}, {int(confidence * 100)}% CI "
                  f"[{fmt(lo_ci)}, {fmt(hi_ci)}]"
                  + ("" if identifiable else
                     "  — FLAT PROFILE: practically unidentifiable over "
                     "this range"))
        return out

    def model_evidence(self, particles=1024, n_moves=5, ess_target=0.5,
                       static_parameters=(), print_report=True,
                       drift_only=False, **solver_kw):
        """Log model evidence (marginal likelihood) and posterior particles
        by tempered Sequential Monte Carlo (samplers/smc.py;
        ``odelib_tpu``'s ``model_evidence``).

        Anneals ``particles`` LHS prior draws from the prior to the
        posterior with an ESS-adaptive temperature ladder, each stage's
        ``n_moves`` rejuvenation sweeps a batched solve of every particle
        with the framework's solver (adaptive Dopri5 by default), keyed
        from ``PRNGKey(random_seed)``. Returns a dict with
        ``log_evidence`` (log of ``∫ exp(-chi) * prior``; the Bayes factor
        between two models of the same data is ``exp(logZ_a - logZ_b)``),
        ``posterior`` (equal-weight particles: pnames..., chi, rsquared,
        aic), ``betas`` and ``acceptance``. Every non-static parameter
        must carry a prior; static parameters are held at their current
        values (the evidence is conditioned on them).
        """
        self._require_deterministic(
            'model_evidence', drift_only,
            hint="SMC evidence over a particle-filter likelihood (SMC^2) "
                 "is not implemented. ")
        from . import random as jr
        from .samplers.smc import smc_sample

        static_parameters = list(static_parameters)
        has_prior = [self.parameters[p] is not None
                     and self.parameters[p].has_distribution()
                     and p not in static_parameters for p in self._pnames]
        free_missing = [p for p, h in zip(self._pnames, has_prior)
                        if not h and p not in static_parameters]
        if free_missing:
            raise ValueError(
                f"model_evidence requires a prior on every free parameter; "
                f"missing: {free_missing} (declare them static via "
                f"static_parameters=... to hold them fixed)")
        offsets = self._spec.theta_offsets
        mask = np.zeros(self._spec.theta_size)
        for i, h in enumerate(has_prior):
            shp = self._spec.pshapes[i]
            if h:
                mask[offsets[i]:offsets[i] + (int(np.prod(shp)) if shp
                                              else 1)] = 1.0
        # zero-template entries of array parameters are pinned at 0
        mask = self._pin_zero_templates(mask)
        theta0 = np.array(self._theta_from_df(
            self._lhs_samples(particles)), float)
        # static parameters (and any dim without a prior) are conditioned
        # on, not marginalized: pinned to the current values
        cur = np.asarray(self._current_theta(), float)
        pin = mask == 0.0
        theta0[:, pin] = cur[pin]
        method, rtol, atol, max_steps, substeps = self._solver_args(
            solver_kw, len(self._times_fit) - 1)
        out = smc_sample(
            self._spec, self._obsdata_fit_host, self._times_fit,
            self.get_inits(), theta0,
            jr.PRNGKey(int(self.random_seed), device=self.device),
            prior_logpdf=self._prior_logpdf(skip=static_parameters),
            n_moves=int(n_moves), ess_target=float(ess_target),
            walk_mask=mask, method=method, rtol=rtol, atol=atol,
            max_steps=max_steps, substeps=substeps, device=self.device)
        df = self._theta_frame(out.theta.cpu().numpy())
        df["chi"] = out.chi.cpu().numpy()
        df["rsquared"] = out.rsquared.cpu().numpy()
        df["aic"] = out.aic.cpu().numpy()
        if print_report:
            print(f"SMC evidence: logZ = {out.log_evidence:.3f} over "
                  f"{len(out.betas) - 1} stages "
                  f"(mean mutation acceptance "
                  f"{float(np.mean(out.acceptance)):.3f})")
        return {"log_evidence": out.log_evidence, "posterior": df,
                "betas": out.betas, "acceptance": out.acceptance}

    def _posterior_logpred(self, posterior, n_draws, solver_kw,
                           stochastic=None):
        """(S, N) log predictions at the observation points of ``n_draws``
        posterior rows (``posterior.sample(n_draws, random_state=
        random_seed)`` when there are more): one batched float64 solve of
        every draw with the framework's solver on its device, or with
        ``stochastic`` (default: the model has a diffusion) one SDE path a
        draw, draw i keyed ``fold_in(PRNGKey(random_seed), i)`` (Euler,
        the integer ``substeps`` or 4)."""
        from . import random as jr
        from .model import integrate_theta, observe, sdeint_theta

        pnames = list(self.get_pnames())
        rows = posterior.dropna(subset=pnames)
        if len(rows) == 0:
            raise ValueError("posterior has no complete parameter rows")
        if len(rows) > n_draws:
            rows = rows.sample(int(n_draws), random_state=self.random_seed)
        thetas = torch.as_tensor(self._theta_from_df(rows[pnames]),
                                 dtype=torch.float64, device=self.device)
        method, rtol, atol, max_steps, substeps = self._solver_args(
            solver_kw, len(self._times_fit) - 1)
        y0 = torch.as_tensor(self.get_inits(), dtype=torch.float64,
                             device=self.device)
        obs = self._obsdata_fit_host
        if stochastic is None:
            stochastic = self._spec.diffusion is not None
        if stochastic:
            keys = jr.fold_in(jr.PRNGKey(self.random_seed,
                                         device=self.device),
                              torch.arange(len(thetas), device=self.device))
            ys = sdeint_theta(self._spec, thetas, y0, self._times_fit, keys,
                              substeps=substeps if isinstance(substeps, int)
                              else 4, method="euler")
            ys = ys.permute(1, 2, 0)
        else:
            ys = integrate_theta(
                self._spec, thetas, self._spec.override_inits(y0, thetas),
                self._times_fit, method=method, rtol=rtol, atol=atol,
                max_steps=max_steps, substeps=substeps)
        return torch.log(observe(self._spec, obs, ys)).cpu().numpy()

    def _pointwise_loglik(self, logpred):
        """(draws, obs) exact pointwise log-likelihood matrix (constants
        included: WAIC and LOO need true densities) under the framework's
        observation model, and the valid-observation mask. ``logpred``:
        (draws, obs) log predictions at the observation points."""
        from scipy.special import gammaln

        obs = self._obsdata_fit_host
        m = self._spec.obs_model
        nu_or_r = self._spec.obs_param
        S_ = np.asarray(obs.log_sigma, np.float64)
        if m in ("poisson", "negbinom"):
            O = np.asarray(obs.abundance, np.float64)
            valid = np.isfinite(O)
            with np.errstate(over="ignore"):
                lam = np.exp(logpred)
            if m == "poisson":
                ll = (O[None, :] * logpred - lam
                      - gammaln(O + 1.0)[None, :])
            else:
                r = nu_or_r
                ll = (gammaln(O + r) - gammaln(r) - gammaln(O + 1.0)
                      )[None, :] \
                    + r * np.log(r / (r + lam)) \
                    + O[None, :] * (logpred - np.log(r + lam))
            return ll, valid
        O = np.asarray(obs.log_abundance, np.float64)
        valid = np.isfinite(O)
        t = (O[None, :] - logpred) / S_[None, :]
        if m == "student_t":
            nu = nu_or_r
            ll = (gammaln((nu + 1.0) / 2.0) - gammaln(nu / 2.0)
                  - 0.5 * np.log(nu * np.pi) - np.log(S_[None, :])
                  - 0.5 * (nu + 1.0) * np.log1p(t * t / nu))
        else:
            ll = (-0.5 * t * t - np.log(S_[None, :])
                  - 0.5 * np.log(2.0 * np.pi))
        return ll, valid

    def information_criteria(self, posterior, n_draws=400,
                             print_report=True, **solver_kw):
        """WAIC and PSIS-LOO from a posterior DataFrame (``odelib_tpu``'s
        ``information_criteria``; utils/model_comparison.py): ``n_draws``
        rows re-solved in one batch, their pointwise log-likelihood matrix
        reduced to ``waic`` (elpd_waic, p_waic, waic, se_elpd_waic) and
        ``loo`` (elpd_loo, p_loo, looic, se_elpd_loo, the per-point Pareto
        ``khat`` and ``n_bad_khat``, k > 0.7), with ``n_draws`` and
        ``n_obs``. Draws whose solve failed are dropped (a warning); fewer
        than 20 left raise. A stochastic model is scored on its drift (a
        warning)."""
        from .utils import model_comparison as _mc

        if self._spec.diffusion is not None:
            warnings.warn(
                "information_criteria on a stochastic model uses the "
                "drift-only (deterministic) predictions: a single path's "
                "pointwise density is not the filtering marginal "
                "likelihood. Treat WAIC/LOO as approximate here.")
        logpred = self._posterior_logpred(posterior, n_draws, solver_kw,
                                          stochastic=False)
        ll, valid = self._pointwise_loglik(logpred)
        ll = ll[:, valid]
        finite_rows = np.all(np.isfinite(ll), axis=1)
        if not finite_rows.all():
            warnings.warn(f"dropping {int((~finite_rows).sum())} posterior "
                          "draws with failed integrations from the "
                          "log-likelihood matrix")
            ll = ll[finite_rows]
        if len(ll) < 20:
            raise ValueError(f"only {len(ll)} finite posterior draws — too "
                             "few for WAIC/LOO")
        w = _mc.waic(ll)
        lo = _mc.psis_loo(ll)
        if print_report:
            print(f"WAIC: elpd = {w['elpd_waic']:.2f} "
                  f"(se {w['se_elpd_waic']:.2f}), p_waic = "
                  f"{w['p_waic']:.2f}")
            print(f"PSIS-LOO: elpd = {lo['elpd_loo']:.2f} "
                  f"(se {lo['se_elpd_loo']:.2f}), p_loo = "
                  f"{lo['p_loo']:.2f}, bad khat: {lo['n_bad_khat']}"
                  f"/{ll.shape[1]}")
        return {"waic": w, "loo": lo, "n_draws": int(len(ll)),
                "n_obs": int(ll.shape[1])}

    def posterior_predictive(self, posterior, n_draws=200, ci=0.9,
                             print_report=True, **solver_kw):
        """Posterior predictive check (``odelib_tpu``'s
        ``posterior_predictive``): replicated observations of ``n_draws``
        posterior rows (one batched solve, the observation model's noise
        from ``numpy.random.default_rng(random_seed)``; for a stochastic
        model one SDE path a draw) against the data. Returns ``summary``
        (per observation: organism, time, the observed value, the
        predictive median and ``ci`` interval, ``covered``), ``coverage``
        (the covered fraction, near ``ci`` for a well-specified model) and
        ``samples`` (draws x observations)."""
        logpred = self._posterior_logpred(posterior, n_draws, solver_kw)
        return self._predictive_summary(logpred, ci, print_report,
                                        "posterior predictive")

    def prior_predictive(self, samples=200, ci=0.9, print_report=True,
                         **solver_kw):
        """Prior predictive check (``odelib_tpu``'s ``prior_predictive``):
        as :meth:`posterior_predictive` from ``samples`` LHS prior draws
        (the port's LHS, :meth:`_lhs_samples`). Coverage far below ``ci``:
        the priors cannot generate the data; near 1 with huge intervals:
        they are uninformatively wide."""
        draws = self._lhs_samples(int(samples))
        logpred = self._posterior_logpred(draws, int(samples), solver_kw)
        return self._predictive_summary(logpred, ci, print_report,
                                        "prior predictive")

    def _predictive_summary(self, logpred, ci, print_report, label):
        """The predictive checks' coverage summary: observation noise of
        the framework's observation model added to ``logpred``, per-point
        intervals and their coverage. Log-space models compare in log
        abundance (column ``log_abundance``), count models simulate counts
        and compare in linear space (column ``abundance``)."""
        obs = self._obsdata_fit_host
        Sg = np.asarray(obs.log_sigma, float)
        rng = np.random.default_rng(self.random_seed)
        m = self._spec.obs_model
        if m in ("poisson", "negbinom"):
            O = np.asarray(obs.abundance, float)
            with np.errstate(over="ignore"):
                lam = np.exp(logpred)
            lam_ok = np.isfinite(lam)
            # counts overflow int64 well before a float rate does; those
            # points are masked back to NaN below
            lam_s = np.clip(np.where(lam_ok, lam, 0.0), 0.0, 1e15)
            if m == "poisson":
                sims = rng.poisson(lam_s).astype(float)
            else:
                r = self._spec.obs_param
                sims = rng.poisson(rng.gamma(r, lam_s / r)).astype(float)
            sims = np.where(lam_ok, sims, np.nan)
            value_col = "abundance"
        else:
            O = np.asarray(obs.log_abundance, float)
            if m == "student_t":
                eps = rng.standard_t(self._spec.obs_param, logpred.shape)
            else:
                eps = rng.normal(0.0, 1.0, logpred.shape)
            sims = logpred + Sg[None, :] * eps
            value_col = "log_abundance"
        alpha = (1.0 - float(ci)) / 2.0
        lo = np.nanquantile(sims, alpha, axis=0)
        hi = np.nanquantile(sims, 1.0 - alpha, axis=0)
        med = np.nanmedian(sims, axis=0)
        covered = (O >= lo) & (O <= hi)
        valid = np.isfinite(O)
        snames = list(self._spec.post_snames)
        sidx = np.asarray(obs.state_index, int)
        times = np.asarray(self._times_fit, float)
        tidx = np.asarray(obs.t_index, int)
        summary = pd.DataFrame({
            "organism": [snames[i] for i in sidx],
            "time": times[tidx],
            value_col: O,
            "pred_median": med, "pred_lo": lo, "pred_hi": hi,
            "covered": covered,
        }).loc[valid]
        coverage = float(covered[valid].mean())
        if print_report:
            print(f"{label}: {coverage:.1%} of observations "
                  f"inside the {int(ci * 100)}% interval "
                  f"({int(covered[valid].sum())}/{int(valid.sum())})")
        return {"summary": summary.reset_index(drop=True),
                "coverage": coverage, "samples": sims}

    def diagnostics(self, posteriors) -> pd.DataFrame:
        """Convergence diagnostics of an MCMC posterior with the
        ``chain#`` column: per parameter mean, std, median, effective
        sample size (FFT autocovariance, Geyer truncation), ESS per draw
        and split-chain R-hat (:func:`~odelib_tpu_torch.utils.
        summarize`)."""
        from .utils.diagnostics import summarize
        return summarize(posteriors, list(self.get_pnames()))

    def sbc(self, reps=128, iterations_per_chain=2000, thin=10, bins=16,
            rwalk_std=0.05, burnin=None, static_parameters=(),
            print_report=True, drift_only=False, **solver_kw) -> dict:
        """Simulation-based calibration of the whole pipeline (Talts et al.
        2018; ``odelib_tpu``'s ``sbc``): ``reps`` replications each draw
        true parameters from the priors, simulate data with this
        framework's observation design and noise model, run an MH chain on
        it (fixed-step Dopri5, or rk4) and rank the truth among the
        thinned draws; all replications one batched loop on the
        framework's device (utils/sbc.py). Returns ``ranks`` (a column per
        prior parameter or array slot), ``pvalues`` (chi-square
        uniformity), ``n_draws`` (M), ``n_valid``, ``reps``,
        ``mean_acceptance`` and ``calibrated`` (every p > 0.01)."""
        self._require_deterministic(
            'sbc', drift_only,
            hint="Calibration of the stochastic pipeline would need "
                 "per-replication PMMH (data-dependent filters). ")
        from .utils.sbc import rank_uniformity_pvalue, sbc_ranks

        offsets = self._spec.theta_offsets
        dists = [None] * self._spec.theta_size
        labels = {}
        for i, p in enumerate(self._pnames):
            par = self.parameters[p]
            if par is None or not par.has_distribution() \
                    or p in static_parameters:
                continue
            shp = self._spec.pshapes[i]
            if shp:
                tmpl = np.ravel(np.asarray(par.val, float))
                for k in range(tmpl.size):
                    if tmpl[k] != 0:
                        dists[offsets[i] + k] = par.tdist
                        labels[offsets[i] + k] = f"{p}[{k}]"
            else:
                dists[offsets[i]] = par.tdist
                labels[offsets[i]] = p
        if not labels:
            raise ValueError("sbc needs at least one parameter with a "
                             "prior distribution")
        method, _, _, _, substeps = self._solver_args(
            solver_kw, len(self._times_fit) - 1)
        res = sbc_ranks(
            self._spec, self._obsdata_fit_host, self._times_fit,
            self.get_inits(), tuple(dists),
            np.asarray(self._current_theta(), float), reps=int(reps),
            nits=int(iterations_per_chain), burnin=burnin, thin=int(thin),
            rwalk_std=float(rwalk_std), seed=int(self.random_seed),
            method="rk4" if method == "rk4" else "fixed_dopri5",
            substeps=substeps, device=self.device)
        valid = np.asarray(res.valid, bool)
        cols = {lab: res.ranks[valid, j] for j, lab in labels.items()}
        ranks_df = pd.DataFrame(cols)
        pvalues = {lab: rank_uniformity_pvalue(ranks_df[lab], res.n_draws,
                                               bins=bins)
                   for lab in ranks_df}
        out = {"ranks": ranks_df, "pvalues": pvalues,
               "n_draws": int(res.n_draws), "n_valid": int(valid.sum()),
               "reps": int(reps),
               "mean_acceptance": float(np.mean(res.acceptance[valid]))
               if valid.any() else float("nan"),
               "calibrated": bool(all(p > 0.01 for p in pvalues.values()))}
        if int(valid.sum()) < reps:
            warnings.warn(
                f"sbc: {reps - int(valid.sum())}/{reps} replications had "
                "non-finite synthetic solves and were dropped — prior "
                "mass is escaping the solver's stable region")
        if print_report:
            lines = ["\nSBC Report (rank-uniformity of the pipeline)\n"
                     "============================================",
                     f"replications: {int(valid.sum())}/{int(reps)} valid, "
                     f"M = {int(res.n_draws)} draws/rank, mean acceptance "
                     f"{out['mean_acceptance']:.3f}"]
            for lab, p in pvalues.items():
                flag = "ok" if p > 0.01 else "MISCALIBRATED"
                lines.append(f"\t{lab}: uniformity p = {p:0.3f}  [{flag}]")
            print("\n".join(lines))
        return out

    def power_scale_sensitivity(self, posterior, alphas=(0.8, 1.25),
                                threshold=0.05, print_report=True):
        """Prior and likelihood power-scaling sensitivity of a fitted
        posterior, no refit (Kallioinen et al. 2023; ``odelib_tpu``'s
        ``power_scale_sensitivity``): the draws (parameter and ``chi``
        columns of a prior-aware run) are PSIS-reweighted to ``prior^a``
        (per parameter, its prior from the port's distributions' ``logpdf``
        on the framework's device) and ``lik^a``; each varying positive
        slot's normalized shift and its diagnosis (utils/sensitivity.py).
        Returns DataFrame[parameter, prior_sens, lik_sens, khat,
        diagnosis]."""
        from .utils.sensitivity import power_scale_sensitivity as _ps

        if self._spec.diffusion is not None:
            warnings.warn(
                "power_scale_sensitivity on a PMMH posterior reweights "
                "by the particle filter's NOISY log-likelihood estimate "
                "(the chi column): the power-scaled shifts are "
                "approximate — treat flags near the threshold with "
                "caution.")
        tdists = tuple(self.parameters[p].tdist
                       if self.parameters[p] is not None else None
                       for p in self._pnames)
        if all(d is None for d in tdists):
            raise ValueError("power_scale_sensitivity needs at least one "
                             "parameter with a prior distribution")
        finite = posterior[np.isfinite(posterior["chi"].astype(float))]
        thetas = np.asarray(self._theta_from_df(finite), float)
        chi = finite["chi"].to_numpy(float)
        # per-PARAMETER prior factors (selective scaling): dimension j's
        # prior sensitivity scales only the prior of the parameter owning
        # slot j
        spec = self._spec
        masks = (self._prior_nonzero_masks()
                 if any(s for s in spec.pshapes)
                 else (None,) * len(tdists))
        th = torch.as_tensor(thetas, device=self.device)
        parts = []
        for d, v, mk in zip(tdists, spec.unpack_theta(th), masks):
            if d is None:
                parts.append(torch.zeros(len(th), dtype=th.dtype,
                                         device=th.device))
                continue
            lp = d.logpdf(v)
            if mk is not None:
                keep = torch.as_tensor(np.asarray(mk, bool).reshape(
                    v.shape[1:]), device=th.device)
                lp = torch.where(keep, lp, 0.0)
            parts.append(lp.reshape(len(th), -1).sum(-1))
        parts = torch.stack(parts, dim=1).cpu().numpy()
        # per-parameter columns to per-SLOT columns
        slot_cols, labels = [], []
        for i, p in enumerate(self._pnames):
            shp = spec.pshapes[i]
            n = int(np.prod(shp)) if shp else 1
            slot_cols += [parts[:, i]] * n
            labels += [f"{p}[{k}]" for k in range(n)] if shp else [p]
        log_prior = np.stack(slot_cols, axis=1)
        # slots that move and stay positive (a log-space diagnostic):
        # zero-template entries and static parameters drop out
        keep = [j for j in range(thetas.shape[1])
                if np.ptp(thetas[:, j]) > 0 and np.all(thetas[:, j] > 0)]
        if not keep:
            raise ValueError("no varying positive parameter slots in the "
                             "posterior")
        df = _ps(np.log(thetas[:, keep]), -chi, log_prior[:, keep],
                 alphas=tuple(alphas), threshold=float(threshold),
                 labels=[labels[j] for j in keep])
        if print_report:
            print(_power_scale_report(
                df, threshold, "\nPower-scaling sensitivity (prior | "
                "likelihood)\n=============================================="
                ))
        return df

    def sobol_sensitivity(self, samples=512, target="chi", n_boot=200,
                          print_report=True, drift_only=False,
                          **solver_kw) -> pd.DataFrame:
        """Variance-based global sensitivity over the priors
        (``odelib_tpu``'s ``sobol_sensitivity``): first-order (S1) and
        total-order (ST) Sobol indices per prior slot with bootstrap
        standard errors (utils/sensitivity.py). ``target``: 'chi', a
        post-summation state name (its final-time value) or ``('log',
        name)``. The Saltelli design, ``samples * (P + 2)`` solves from
        key ``PRNGKey(random_seed ^ 0x50B01)`` on the JAX package's
        stream, runs as one batched solve on the framework's device with
        its solver; parameters without a prior stay at their current
        values. Returns DataFrame[S1, S1_se, ST, ST_se] indexed by
        slot."""
        self._require_deterministic(
            'sobol_sensitivity', drift_only,
            hint="Sensitivity targets are drift statistics. ")
        from . import random as jr
        from .distributions import ArrayHyper
        from .utils import sensitivity as _sens

        # one dimension per flat slot with a prior: scalars directly, an
        # array parameter one per non-zero template entry, "<p>[k]"
        free = []
        offsets = self._spec.theta_offsets
        for i, p in enumerate(self._pnames):
            par = self.parameters[p]
            if par is None or not par.has_distribution():
                continue
            shp = self._spec.pshapes[i]
            d = par.tdist
            if shp:
                tmpl = np.ravel(np.asarray(par.val, float))
                free.extend((offsets[i] + k, f"{p}[{k}]",
                             d.element(k) if isinstance(d, ArrayHyper)
                             else d)
                            for k in range(tmpl.size) if tmpl[k] != 0)
            else:
                free.append((offsets[i], p, d))
        if len(free) < 2:
            raise ValueError("sobol_sensitivity needs >= 2 parameters "
                             "with prior distributions")
        if target == "chi":
            tgt = ("chi",)
        else:
            if isinstance(target, tuple) and target[0] == "log":
                kind, sname = "log_state", target[1]
            else:
                kind, sname = "state", target
            if sname not in self._spec.post_snames:
                raise ValueError(f"unknown state {sname!r}; have "
                                 f"{self._spec.post_snames}")
            tgt = (kind, self._spec.post_snames.index(sname))

        key = jr.PRNGKey(self.random_seed ^ 0x50B01, device=self.device)
        design, N, P = _sens.saltelli_design(
            key, [d for _, _, d in free], int(samples))
        thetas = torch.as_tensor(self._current_theta(), dtype=torch.float64,
                                 device=self.device).repeat(len(design), 1)
        for col, (i, _, _) in enumerate(free):
            thetas[:, i] = design[:, col]
        method, rtol, atol, max_steps, substeps = self._solver_args(
            solver_kw, len(self._times_fit) - 1)
        f = _sens._eval_target(
            self._spec, self._obsdata_fit_host, self._times_fit,
            self.get_inits(), thetas, target=tgt,
            num_params=len(self._pnames), method=method, rtol=rtol,
            atol=atol, max_steps=max_steps,
            substeps=substeps).cpu().numpy()
        fA, fB = f[:N], f[N:2 * N]
        fAB = f[2 * N:].reshape(P, N)
        res = _sens.sobol_indices(fA, fB, fAB, n_boot=int(n_boot),
                                  seed=self.random_seed)
        out = pd.DataFrame(
            {"S1": res["S1"], "S1_se": res["S1_se"],
             "ST": res["ST"], "ST_se": res["ST_se"]},
            index=[p for _, p, _ in free])
        if print_report:
            t = target if isinstance(target, str) else "/".join(
                map(str, target))
            print(f"Sobol indices on {t} "
                  f"({res['n_effective']}/{N} finite samples):")
            print(out.round(3).to_string())
        return out

    def local_sensitivity(self, parameters=None, log_scale=True,
                          drift_only=False, **solver_kw):
        """Time-resolved local sensitivities d state / d (log) parameter
        along the current (or the given) trajectory, by reverse-mode
        differentiation through the fixed-step solve (fixed Dopri5, or rk4)
        in float64 on the framework's device (``odelib_tpu``'s
        ``local_sensitivity``): ``{state_name: DataFrame(index=times,
        columns=labels)}``, an array parameter one column per non-zero
        template entry, ``"<p>[k]"``."""
        self._require_deterministic(
            'local_sensitivity', drift_only,
            hint="Sensitivities are along the drift trajectory. ")
        from .utils import sensitivity as _sens

        if parameters is None:
            theta = self._current_theta()
        else:
            theta = self._spec.pack_theta(list(parameters))
        method, _, _, _, substeps = self._solver_args(
            solver_kw, len(self._times_fit) - 1)
        J = _sens.local_sensitivity(
            self._spec, torch.as_tensor(np.asarray(theta, np.float64),
                                        device=self.device),
            self.get_inits(), self._times_fit, log_scale=bool(log_scale),
            method="rk4" if method == "rk4" else "fixed_dopri5",
            substeps=substeps).cpu().numpy()
        offsets = self._spec.theta_offsets
        keep, labels = [], []
        for i, p in enumerate(self._pnames):
            shp = self._spec.pshapes[i]
            if not shp:
                keep.append(offsets[i])
                labels.append(p)
                continue
            par = self.parameters[p]
            tmpl = np.ravel(np.asarray(
                par.val if par is not None else np.ones(shp), float))
            for k in range(tmpl.size):
                if tmpl[k] != 0:
                    keep.append(offsets[i] + k)
                    labels.append(f"{p}[{k}]")
        return {s: pd.DataFrame(J[:, i, keep], index=self._times_fit,
                                columns=labels)
                for i, s in enumerate(self._spec.post_snames)}


def _power_scale_report(df, threshold, header):
    """The power-scaling table under ``header`` as the reports print
    it."""
    lines = [header]
    for _, r in df.iterrows():
        lines.append(
            f"\t{r['parameter']}: prior {r['prior_sens']:0.3f}, "
            f"likelihood {r['lik_sens']:0.3f}  [{r['diagnosis']}]")
    lines.append(f"(threshold {threshold}; khat max "
                 f"{df['khat'].max():0.2f} — reweighting reliable "
                 f"below 0.7)")
    return "\n".join(lines)
