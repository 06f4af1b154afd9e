"""Point estimates, variational fits and evidence: the inference methods
that ``ModelFramework`` mixes in.

Counterpart of the first part of ``odelib_tpu/api_inference.py``'s
``InferenceMixin``: ``fit_map`` (multi-start Adam, samplers/optimize.py),
``laplace_approximation`` (the Hessian of the potential by double
backward through the fixed-step solve), ``fit_advi`` (samplers/advi.py),
``profile_likelihood`` (every grid point x start one lane of
``map_fit``) and ``model_evidence`` (tempered SMC, samplers/smc.py). The
solves run in float64 on the framework's device (``device='cpu'`` when
the framework was built so); the host steps (the pseudo-inverse, the
chi-square threshold, Pareto smoothing, the tempering schedule) are numpy
and scipy, as in the reference. A stochastic (``diffusion=``) model is
refused unless the caller passes ``drift_only=True``, which warns.
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
