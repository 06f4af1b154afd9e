"""User-facing joint multi-experiment fitting: ``JointFit``.

Counterpart of ``odelib_tpu/joint.py`` for complete pooling (``shared``)
and no pooling (the default) of scalar parameters: ``JointFit`` ties named
parameters across several ``ModelFramework`` instances (the same or
different models, each with its own data) and samples the joint posterior
with every experiment scored in one kernel per iteration
(:mod:`odelib_tpu_torch.ops.cuda_joint`; its torch twin on a CPU
framework). The joint layout, LHS survey, seeding, posterior frame and
report are the JAX package's. Not ported yet, each raising
``NotImplementedError`` naming its ROADMAP item: ``hierarchical=``,
array parameters, stochastic experiments (joint PMMH), ``sampler='hmc'``,
``backend='xla'``, ``use_priors=True``, checkpointing and
``until_rhat``/``until_min_ess``.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import pandas as pd
import torch

from . import stats as tstats
from .samplers.joint import joint_survey
from .samplers.lhs import sample_lhs

__all__ = ["JointFit"]


class JointFit:
    """Fit K experiments with tied parameters.

    ``frameworks``: dict name -> ModelFramework (or a list; names become
    ``exp0``, ``exp1``, ...), each with its own data and all on one
    device. ``shared``: parameter names tied across all frameworks (each
    must exist in every framework); the others are per-experiment.

    Joint layout: ``[shared..., <name>:<p> for each experiment's free
    parameters...]``; posterior columns use the same naming. Priors for
    shared parameters come from the first framework.
    """

    def __init__(self, frameworks, shared=(), hierarchical=(),
                 hyperpriors=None, random_seed=0):
        if not isinstance(frameworks, dict):
            frameworks = {f"exp{i}": f for i, f in enumerate(frameworks)}
        if len(frameworks) < 2:
            raise ValueError("JointFit needs at least two experiments")
        if hierarchical or hyperpriors:
            raise NotImplementedError(
                "hierarchical= (partial pooling) is not ported yet (ROADMAP "
                "queue 1, item 16)")
        self.frameworks = dict(frameworks)
        self.shared = list(shared)
        self.hierarchical = []
        self.random_seed = random_seed
        self._stoch = {nm for nm, fw in self.frameworks.items()
                       if fw._spec.diffusion is not None}
        for nm, fw in self.frameworks.items():
            if fw.df is None:
                raise ValueError(f"experiment {nm!r} has no data")
            missing = [p for p in self.shared if p not in fw._pnames]
            if missing:
                raise ValueError(f"experiment {nm!r} lacks tied "
                                 f"parameter(s) {missing}")
        devices = {fw.device for fw in self.frameworks.values()}
        if len(devices) != 1:
            raise ValueError(f"the frameworks run on different devices "
                             f"{sorted(map(str, devices))}")
        self.device = devices.pop()
        first = next(iter(self.frameworks.values()))

        # joint layout: one slot per (scalar) parameter
        self.columns = []        # labels, layout order
        self._col_offsets = {}   # label -> slot
        self._col_params = {}    # label -> (owning framework, pname)
        self.dim = 0

        def add_column(lab, fw, p):
            self.columns.append(lab)
            self._col_offsets[lab] = self.dim
            self._col_params[lab] = (fw, p)
            self.dim += 1

        for p in self.shared:
            add_column(p, first, p)
        self._idx_maps = {}
        for nm, fw in self.frameworks.items():
            idx = []
            for p in fw._pnames:
                if p not in self.shared:
                    add_column(f"{nm}:{p}", fw, p)
                idx.append(self._col_offsets[p if p in self.shared
                                             else f"{nm}:{p}"])
            self._idx_maps[nm] = tuple(idx)

    def _dists(self):
        """Prior distribution (or None) per joint slot."""
        out = [None] * self.dim
        for lab in self.columns:
            fw, p = self._col_params[lab]
            par = fw.parameters[p]
            if par is not None and par.has_distribution():
                out[self._col_offsets[lab]] = par.tdist
        return out

    def _current_joint_theta(self):
        th = np.zeros(self.dim)
        for lab in self.columns:
            fw, p = self._col_params[lab]
            par = fw.parameters[p]
            if par is not None:
                th[self._col_offsets[lab]] = float(np.asarray(par.val, float))
        return th

    def _df_from_thetas(self, thetas, base=None):
        """(N, dim) joint thetas -> DataFrame with one float64 column per
        parameter label."""
        thetas = np.asarray(thetas, float)
        data = {} if base is None else dict(base)
        for lab in self.columns:
            data[lab] = thetas[:, self._col_offsets[lab]]
        return pd.DataFrame(data)

    def _thetas_from_df(self, df):
        """Inverse of :meth:`_df_from_thetas`; missing columns fill from
        the current framework values."""
        th = np.tile(self._current_joint_theta(), (len(df), 1))
        for lab in self.columns:
            if lab in df:
                th[:, self._col_offsets[lab]] = np.asarray(df[lab], float)
        return th

    def _device_args(self, solver_kw):
        """(specs, idx maps, host obs, compact grids, y0s, method, substeps
        per experiment): the first framework's method as a fixed-step
        survey method, each framework's own substeps."""
        specs, idxs, obs, times, y0s, subs = [], [], [], [], [], []
        method = None
        for nm, fw in self.frameworks.items():
            specs.append(fw._spec)
            idxs.append(self._idx_maps[nm])
            obs.append(fw._obsdata_fit_host)
            times.append(np.asarray(fw._times_fit, np.float64))
            y0s.append(np.asarray(fw.get_inits(), np.float64))
            m, _, _, _, sub = fw._solver_args(solver_kw)
            subs.append(sub)
            if method is None:
                method = m
        method = "rk4" if method == "rk4" else "fixed_dopri5"
        return (tuple(specs), tuple(idxs), tuple(obs), tuple(times),
                tuple(y0s), method, tuple(subs))

    def _walk_mask(self, static_parameters=()):
        """Static parameters stay fixed."""
        mask = np.ones(self.dim)
        for p in static_parameters:
            if p not in self.columns:
                raise ValueError(f"unknown static parameter {p!r} "
                                 f"(joint columns: {self.columns})")
            mask[self._col_offsets[p]] = 0.0
        return mask

    def _seed_hyper_slots(self, theta0):
        """Hyperparameter slots of hierarchical pooling (not ported): no-op."""
        return theta0

    def fit_survey(self, samples=1000, **solver_kw) -> pd.DataFrame:
        """LHS over the joint priors (a ``torch.Generator`` seeded from
        ``random_seed``) -> DataFrame[columns..., chi], scored by
        :func:`~odelib_tpu_torch.samplers.joint.joint_survey` in float64
        on the frameworks' device with fixed steps."""
        dists = self._dists()
        cur = self._current_joint_theta()
        draw_dims = [j for j, d in enumerate(dists) if d is not None]
        thetas = np.tile(cur, (samples, 1))
        if draw_dims:
            gen = torch.Generator().manual_seed(int(self.random_seed))
            thetas[:, draw_dims] = sample_lhs(
                gen, [dists[j] for j in draw_dims], samples).numpy()
        specs, idxs, obs, times, y0s, method, subs = \
            self._device_args(solver_kw)
        chis = joint_survey(
            specs, idxs, obs, times, y0s,
            torch.as_tensor(thetas, dtype=torch.float64, device=self.device),
            method=method, substeps_list=subs).cpu().numpy()
        df = self._df_from_thetas(thetas)
        df["chi"] = np.where(np.isfinite(chis), chis, np.nan)
        return df

    def MCMC(self, chain_inits=32, iterations_per_chain=1000,
             fitsurvey_samples=1000, use_priors=False, rwalk_std=0.05,
             burnin=None, static_parameters=(), print_report=True,
             backend="auto", sampler="mh", n_leapfrog=4, step_size=0.02,
             path_adapt=False, dense_mass=False,
             until_rhat=None, until_min_ess=None, max_extensions=8,
             checkpoint_every=None, checkpoint_path=None,
             resume_from=None, pallas_tile_chains=None,
             pallas_interpret=False, n_particles=128, sde_substeps=4,
             sde_method="euler", adapt_proposal=True, profile=False,
             **solver_kw) -> pd.DataFrame:
        """Joint MCMC posterior over all experiments: one launch of the
        joint kernel (its twin on a CPU framework).

        Chains seed from the best ``chain_inits`` of ``fitsurvey_samples``
        LHS prior draws (sampled with replacement among the lowest chi).
        Returns a DataFrame with the joint columns plus total ``chi``,
        per-experiment ``chi:<name>``, ``iteration``, ``acceptance_ratio``,
        ``chain#`` and ``all_rejected``, one row per recorded joint sample.
        ``profile=True`` records each stage's wall seconds in
        ``last_profile`` (synchronising the device at each boundary).
        ``pallas_tile_chains``, ``pallas_interpret`` and the HMC and SDE
        knobs are accepted; the options that are not ported raise
        ``NotImplementedError`` naming their ROADMAP item.
        """
        if backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"backend must be 'auto', 'pallas' or 'xla', "
                             f"got {backend!r}")
        if sampler not in ("mh", "hmc"):
            raise ValueError(f"sampler must be 'mh' or 'hmc', got "
                             f"{sampler!r}")
        if self._stoch:
            raise NotImplementedError(
                f"stochastic experiment(s) {sorted(self._stoch)}: joint "
                "PMMH runs on the XLA samplers/joint.py, not ported yet "
                "(ROADMAP queue 1, item 15)")
        if sampler == "hmc":
            raise NotImplementedError(
                "sampler='hmc' is not ported yet (ROADMAP queue 1, item 16)")
        if backend == "xla":
            raise NotImplementedError(
                "backend='xla': the XLA samplers/joint.py is not ported yet "
                "(ROADMAP queue 1, item 15)")
        if use_priors:
            raise NotImplementedError(
                "use_priors=True (in-kernel priors of the joint kernel) is "
                "not ported yet (ROADMAP queue 1, item 12)")
        if checkpoint_every is not None or checkpoint_path is not None \
                or resume_from is not None:
            raise NotImplementedError(
                "checkpointing is not ported yet (ROADMAP queue 1, item 11)")
        if until_rhat is not None or until_min_ess is not None:
            raise NotImplementedError(
                "until_rhat/until_min_ess run-length extension is not "
                "ported yet (ROADMAP queue 1, item 11)")
        stages, clock = {}, [time.perf_counter()]

        def stage_done(name):
            if profile:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                now = time.perf_counter()
                stages[name] = now - clock[0]
                clock[0] = now

        nits = int(iterations_per_chain)
        if burnin is None:
            burnin = int(nits / 2)
        n_chains = int(chain_inits)
        survey = self.fit_survey(fitsurvey_samples, **solver_kw).dropna()
        stage_done("survey")
        if survey.empty:
            raise ValueError("joint pre-survey found no finite-chi draws; "
                             "widen priors or check the data")
        top = survey.nsmallest(max(n_chains, 8), "chi")
        rng = np.random.default_rng(self.random_seed)
        rows = top.iloc[rng.integers(0, len(top), n_chains)]
        theta0 = self._seed_hyper_slots(self._thetas_from_df(rows))
        mask = self._walk_mask(static_parameters)
        specs, idxs, obs, times, y0s, method, subs = \
            self._device_args(solver_kw)
        stage_done("seeding")

        from .ops.cuda_joint import joint_metropolis_hastings_fused
        out = joint_metropolis_hastings_fused(
            specs, idxs, obs, times, y0s,
            torch.as_tensor(np.asarray(theta0, np.float32),
                            device=self.device),
            seed=int(self.random_seed), nits=nits, burnin=int(burnin),
            walk_mask=mask, rwalk_std=float(rwalk_std),
            stepper="rk4" if method == "rk4" else "dopri5",
            substeps_list=subs)
        stage_done("chains")
        posterior = self._posterior_to_df(out, n_chains)
        stage_done("posterior")
        if print_report:
            self._report(posterior)
        stage_done("report")
        if profile:
            self.last_profile = stages
        return posterior

    def _posterior_to_df(self, out, n_chains):
        """Records -> the joint posterior DataFrame, one block of rows per
        chain (built column-wise; the same frame as a per-chain concat)."""
        theta = out.theta[:n_chains].cpu().numpy()          # (C, R, D)
        C, R, _ = theta.shape
        parts = out.chi_parts[:n_chains].cpu().numpy()
        ar = out.acceptance_ratio[:n_chains].cpu().numpy()
        all_rejected = ar[:, -1] == 0.0 if R else np.zeros(C, bool)
        cols = {lab: theta[:, :, self._col_offsets[lab]].reshape(-1)
                .astype(np.float64) for lab in self.columns}
        cols["chi"] = out.chi[:n_chains].cpu().numpy().reshape(-1)
        for k, nm in enumerate(self.frameworks):
            cols[f"chi:{nm}"] = parts[:, :, k].reshape(-1)
        cols["iteration"] = np.tile(out.iteration.cpu().numpy(), C)
        cols["acceptance_ratio"] = ar.reshape(-1)
        cols["chain#"] = np.repeat(np.arange(C, dtype=np.int64), R)
        cols["all_rejected"] = np.repeat(all_rejected.astype(bool), R)
        if all_rejected.any():
            warnings.warn(
                f"{int(all_rejected.sum())}/{C} joint chains never "
                "accepted a proposal; their rows repeat the seed draw and "
                "are flagged all_rejected=True")
        return pd.DataFrame(cols)

    def _report(self, posterior):
        report = ["\nJoint Fitting Report\n===================="]
        for col in self.columns:
            median, std = tstats.rawstats(np.array(posterior[col], float))
            report.append(f"parameter: {col}\n\tmedian = "
                          f"{float(median):0.3e}, Standard "
                          f"deviation = {float(std):0.3e}")
        best = posterior.loc[posterior["chi"].idxmin()]
        report.append("\nBest joint sample:")
        report.append("\tChi = {:0.3e} ({})".format(
            best["chi"], ", ".join(f"chi:{nm} = {best[f'chi:{nm}']:0.3e}"
                                   for nm in self.frameworks)))
        print("\n".join(report))

    def set_best_params(self, posterior):
        """Push the min-chi joint sample back into every framework."""
        best = posterior.loc[posterior["chi"].idxmin()]
        for nm, fw in self.frameworks.items():
            fw.set_parameters(**{
                p: float(best[p if p in self.shared else f"{nm}:{p}"])
                for p in fw._pnames})
        return best
