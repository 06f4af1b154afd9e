"""User-facing joint multi-experiment fitting: ``JointFit``.

Counterpart of ``odelib_tpu/joint.py``: complete pooling (``shared``),
no pooling (the default) and partial pooling (``hierarchical``, a
lognormal population law whose median and spread are sampled too).
``JointFit`` ties named parameters (scalar or array-valued, one joint
slot per entry) across several
``ModelFramework`` instances (the same or different models, each with its
own data, observation model, censoring, doses and forcings) and samples
the joint posterior where ``odelib_tpu`` on a TPU runs its fused kernel
with every experiment scored in one kernel per iteration
(:mod:`odelib_tpu_torch.ops.cuda_joint`; its torch twin on a CPU
framework), and elsewhere (``backend='xla'``, priors without an in-kernel
form, censored counts, an RHS that does not trace) on the reference's XLA
joint sampler (:mod:`odelib_tpu_torch.samplers.joint`); a stochastic
(``diffusion=``) experiment sends the fit to joint particle-marginal MH.
``sampler='hmc'`` runs HMC over the summed chi
(:func:`~odelib_tpu_torch.samplers.hmc.hamiltonian_mc_custom`), as does
the reference; ``fit_map`` (multi-start Adam) and ``fit_advi`` run over
the same summed chi and pooling density. ``posterior_predictive``,
``information_criteria`` and ``diagnostics`` slice the joint posterior
per experiment and delegate to each framework, and
``power_scale_sensitivity`` reweights it by per-slot priors. The joint
layout, LHS survey, seeding, posterior frame and report are the JAX
package's, and so are
chunked checkpointing with a bit-exact resume and
``until_rhat``/``until_min_ess`` run-length extension.
"""
from __future__ import annotations

import hashlib
import time
import warnings

import numpy as np
import pandas as pd
import torch

from . import stats as tstats
from .dispatch import require_batched, require_kernel_rhs
from .model import traces
from .samplers.joint import joint_survey
from .samplers.lhs import sample_lhs
from .utils.profiling import StageTimer, get_logger

__all__ = ["JointFit"]


class JointFit:
    """Fit K experiments with tied parameters.

    ``frameworks``: dict name -> ModelFramework (or a list; names become
    ``exp0``, ``exp1``, ...), each with its own data and all on one
    device. ``shared``: parameter names tied across all frameworks (each
    must exist in every framework); the others are per-experiment.
    ``hierarchical``: scalar parameter names partially pooled: experiment
    ``nm`` keeps its own ``<nm>:<p>``, and ``log <nm>:<p> ~ Normal(log
    <p>:pop_median, <p>:pop_sigma)`` with both hyperparameters sampled
    (not overlapping ``shared``). ``hyperpriors``: ``p -> (median_dist,
    sigma_dist)`` (the port's distributions or scipy frozen ones); by
    default the first framework's prior of ``p`` on the median and
    ``LogNormal(s=1, scale=0.3)`` on the spread. The pooling density and
    the hyperpriors are always part of the target; ``use_priors`` adds
    the non-pooled slots' own priors.

    Joint layout: ``[shared..., <name>:<p> for each experiment's free
    parameters..., <p>:pop_median, <p>:pop_sigma for each hierarchical
    p]``, an array parameter one slot per entry (a shared one must have
    one shape in every experiment); posterior columns use the same naming,
    an array parameter's cells holding its array. Priors for shared
    parameters come from the first framework.
    """

    def __init__(self, frameworks, shared=(), hierarchical=(),
                 hyperpriors=None, random_seed=0):
        if not isinstance(frameworks, dict):
            frameworks = {f"exp{i}": f for i, f in enumerate(frameworks)}
        if len(frameworks) < 2:
            raise ValueError("JointFit needs at least two experiments")
        self.frameworks = dict(frameworks)
        self.shared = list(shared)
        self.hierarchical = list(hierarchical)
        self.random_seed = random_seed
        self._stoch = {nm for nm, fw in self.frameworks.items()
                       if fw._spec.diffusion is not None}
        overlap = set(self.shared) & set(self.hierarchical)
        if overlap:
            raise ValueError(f"parameter(s) {sorted(overlap)} cannot be "
                             f"both shared and hierarchical")
        for nm, fw in self.frameworks.items():
            if fw.df is None:
                raise ValueError(f"experiment {nm!r} has no data")
            missing = [p for p in self.shared + self.hierarchical
                       if p not in fw._pnames]
            if missing:
                raise ValueError(f"experiment {nm!r} lacks tied "
                                 f"parameter(s) {missing}")
        devices = {fw.device for fw in self.frameworks.values()}
        if len(devices) != 1:
            raise ValueError(f"the frameworks run on different devices "
                             f"{sorted(map(str, devices))}")
        self.device = devices.pop()
        first = next(iter(self.frameworks.values()))

        def pshape(fw, p):
            return fw._spec.pshapes[list(fw._pnames).index(p)]

        for p in self.shared:
            shp0 = pshape(first, p)
            for nm, fw in self.frameworks.items():
                if pshape(fw, p) != shp0:
                    raise ValueError(
                        f"shared parameter {p!r} has shape {shp0} in the "
                        f"first experiment but {pshape(fw, p)} in {nm!r}")

        # joint flat layout: one slot per scalar parameter or array entry;
        # ``columns`` has one label per parameter
        self.columns = []        # labels, layout order
        self._col_shapes = {}    # label -> () or the array's shape
        self._col_offsets = {}   # label -> first slot
        self._col_params = {}    # label -> (owning framework, pname)
        self.dim = 0

        def add_column(lab, shp, fw, p):
            self.columns.append(lab)
            self._col_shapes[lab] = shp
            self._col_offsets[lab] = self.dim
            self._col_params[lab] = (fw, p)
            self.dim += int(np.prod(shp)) if shp else 1

        for p in self.shared:
            add_column(p, pshape(first, p), first, p)
        self._idx_maps = {}
        for nm, fw in self.frameworks.items():
            idx = []
            for p, shp in zip(fw._pnames, fw._spec.pshapes):
                if p not in self.shared:
                    add_column(f"{nm}:{p}", shp, fw, p)
                off = self._col_offsets[p if p in self.shared
                                        else f"{nm}:{p}"]
                idx.extend(range(off, off + (int(np.prod(shp)) if shp
                                             else 1)))
            self._idx_maps[nm] = tuple(idx)

        # partial pooling: a median and a spread slot per hierarchical
        # parameter after every experiment's slots (in no idx map, so no
        # solve sees them), started at the geometric mean and log-spread
        # (at least 0.1) of the experiments' current values
        from .distributions import LogNormal, from_scipy
        self._hyper_vals = {}      # hyper label -> current value
        self._hyper_priors = {}    # hyper label -> Distribution or None
        self._hyper_cols = {}      # p -> (median label, sigma label)
        hyperpriors = dict(hyperpriors or {})
        unknown = set(hyperpriors) - set(self.hierarchical)
        if unknown:
            raise ValueError(f"hyperpriors given for non-hierarchical "
                             f"parameter(s) {sorted(unknown)}")
        for p in self.hierarchical:
            for nm, fw in self.frameworks.items():
                if pshape(fw, p):
                    raise ValueError(
                        f"hierarchical parameter {p!r} must be scalar "
                        f"(shape {pshape(fw, p)} in experiment {nm!r}); "
                        f"array-valued parameters can be tied with "
                        f"shared= instead")
            lab_m, lab_t = f"{p}:pop_median", f"{p}:pop_sigma"
            add_column(lab_m, (), None, p)
            add_column(lab_t, (), None, p)
            self._hyper_cols[p] = (lab_m, lab_t)
            vals = [float(np.asarray(fw.parameters[p].val))
                    for fw in self.frameworks.values()
                    if fw.parameters[p] is not None
                    and np.all(np.asarray(fw.parameters[p].val) > 0)]
            logs = np.log(vals) if vals else np.zeros(1)
            self._hyper_vals[lab_m] = float(np.exp(logs.mean()))
            self._hyper_vals[lab_t] = float(max(logs.std(), 0.1))
            m_d, t_d = hyperpriors.get(p, (None, None))
            if m_d is None:
                par = first.parameters[p]
                m_d = par.tdist if par is not None \
                    and par.has_distribution() else None
            if t_d is None:
                t_d = LogNormal(s=1.0, loc=0.0, scale=0.3)
            self._hyper_priors[lab_m] = None if m_d is None \
                else from_scipy(m_d)
            self._hyper_priors[lab_t] = None if t_d is None \
                else from_scipy(t_d)

    def _template(self, lab):
        """The flat current value of an array column (None for a scalar):
        its zero entries never walk and draw no LHS dimension."""
        shp = self._col_shapes[lab]
        if not shp:
            return None
        fw, p = self._col_params[lab]
        par = fw.parameters[p]
        return np.ravel(np.asarray(
            par.val if par is not None else np.zeros(shp), float))

    def _dists(self):
        """Prior distribution (or None) per joint slot: an array
        parameter's on each non-zero template entry."""
        out = [None] * self.dim
        for lab in self.columns:
            fw, p = self._col_params[lab]
            if fw is None:                       # a hyperparameter slot
                out[self._col_offsets[lab]] = self._hyper_priors[lab]
                continue
            par = fw.parameters[p]
            d = par.tdist if par is not None and par.has_distribution() \
                else None
            off = self._col_offsets[lab]
            tmpl = self._template(lab)
            if tmpl is None:
                out[off] = d
            else:
                for i, v in enumerate(tmpl):
                    out[off + i] = d if v != 0 else None
        return out

    def _current_joint_theta(self):
        th = np.zeros(self.dim)
        for lab in self.columns:
            fw, p = self._col_params[lab]
            if fw is None:                       # a hyperparameter slot
                th[self._col_offsets[lab]] = self._hyper_vals[lab]
                continue
            par = fw.parameters[p]
            if par is not None:
                v = np.ravel(np.asarray(par.val, float))
                off = self._col_offsets[lab]
                th[off:off + v.size] = v
        return th

    def _df_from_thetas(self, thetas, base=None):
        """(N, dim) joint thetas -> DataFrame with one column per
        parameter label: float64, an array parameter's cells its arrays."""
        thetas = np.asarray(thetas, float)
        data = {} if base is None else dict(base)
        for lab in self.columns:
            off, shp = self._col_offsets[lab], self._col_shapes[lab]
            if shp:
                n = int(np.prod(shp))
                data[lab] = list(thetas[:, off:off + n].reshape(
                    (len(thetas),) + tuple(shp)))
            else:
                data[lab] = thetas[:, off]
        return pd.DataFrame(data)

    def _thetas_from_df(self, df):
        """Inverse of :meth:`_df_from_thetas`; missing columns fill from
        the current framework values."""
        th = np.tile(self._current_joint_theta(), (len(df), 1))
        for lab in self.columns:
            if lab not in df or not len(df):
                continue
            off = self._col_offsets[lab]
            if self._col_shapes[lab]:
                vals = np.stack([np.ravel(np.asarray(v, float))
                                 for v in df[lab].to_numpy()])
            else:
                vals = np.asarray(df[lab], float)[:, None]
            th[:, off:off + vals.shape[1]] = vals
        return th

    def _device_args(self, solver_kw):
        """(specs, idx maps, host obs, compact grids, y0s, method, substeps
        per experiment): the first framework's method as a fixed-step
        survey method, each framework's own substeps ('auto' resolved per
        framework: its calibrated schedule where it fits the framework's
        grid, else 4)."""
        specs, idxs, obs, times, y0s, subs = [], [], [], [], [], []
        method = None
        for nm, fw in self.frameworks.items():
            specs.append(fw._spec)
            idxs.append(self._idx_maps[nm])
            obs.append(fw._obsdata_fit_host)
            times.append(np.asarray(fw._times_fit, np.float64))
            y0s.append(np.asarray(fw.get_inits(), np.float64))
            m, _, _, _, sub = fw._solver_args(solver_kw,
                                              len(fw._times_fit) - 1)
            subs.append(sub)
            if method is None:
                method = m
        method = "rk4" if method == "rk4" else "fixed_dopri5"
        return (tuple(specs), tuple(idxs), tuple(obs), tuple(times),
                tuple(y0s), method, tuple(subs))

    def _walk_mask(self, static_parameters=()):
        """Static parameters stay fixed, and so do zero-template entries
        of array parameters."""
        mask = np.ones(self.dim)
        for p in static_parameters:
            if p not in self.columns:
                raise ValueError(f"unknown static parameter {p!r} "
                                 f"(joint columns: {self.columns})")
            off, shp = self._col_offsets[p], self._col_shapes[p]
            mask[off:off + (int(np.prod(shp)) if shp else 1)] = 0.0
        for lab in self.columns:
            tmpl = self._template(lab)
            if tmpl is not None:
                sl = slice(self._col_offsets[lab],
                           self._col_offsets[lab] + tmpl.size)
                mask[sl] = np.where(tmpl != 0, mask[sl], 0.0)
        return mask

    def _slot_dist(self, j):
        """Slot ``j``'s prior for the LHS: an array hyperparameter's entry
        for an array parameter's slot."""
        from .distributions import ArrayHyper
        d = self._dists()[j]
        if isinstance(d, ArrayHyper):
            lab = max((lab for lab in self.columns
                       if self._col_offsets[lab] <= j),
                      key=lambda lab: self._col_offsets[lab])
            d = d.element(j - self._col_offsets[lab])
        return d

    def _seed_hyper_slots(self, theta0):
        """Each chain's hyperparameter slots from its own experiments'
        values: their geometric mean and log-spread (at least 0.1), so a
        chain starts inside the pooling term's bulk (the survey draws the
        hyper slots independently). No-op without hierarchical
        parameters."""
        for p in self.hierarchical:
            lab_m, lab_t = self._hyper_cols[p]
            logs = np.log(theta0[:, [self._col_offsets[f"{nm}:{p}"]
                                     for nm in self.frameworks]])
            theta0[:, self._col_offsets[lab_m]] = np.exp(logs.mean(axis=1))
            theta0[:, self._col_offsets[lab_t]] = np.maximum(
                logs.std(axis=1), 0.1)
        return theta0

    def _effective_prior(self, use_priors):
        """(prior_logpdf, use_priors) as the samplers see them
        (``odelib_tpu``'s ``_effective_prior``). Without hierarchical
        parameters, the slot priors with ``use_priors``. With them, always
        on: ``sum_k log Normal(log theta_k | log pop_median, pop_sigma)``
        over z = log theta (the space the chains walk), the hyperpriors,
        and with ``use_priors`` the non-pooled slots' priors (a pooled
        slot's prior is the population law)."""
        if not self.hierarchical:
            return ((self._joint_prior_logpdf(), True) if use_priors
                    else (None, False))
        table, hyper, pooled = [], set(), set()
        for p in self.hierarchical:
            ms, ts = (self._col_offsets[lab] for lab in self._hyper_cols[p])
            exps = tuple(self._col_offsets[f"{nm}:{p}"]
                         for nm in self.frameworks)
            hyper.update((ms, ts))
            pooled.update(exps)
            table.append((ms, ts, exps))
        slots = [(j, self._slot_dist(j)) for j, d in enumerate(self._dists())
                 if d is not None
                 and (j in hyper or (use_priors and j not in pooled))]
        half_log_2pi = 0.5 * float(np.log(2.0 * np.pi))

        def prior_logpdf(theta):
            tot = torch.zeros(theta.shape[:-1], dtype=theta.dtype,
                              device=theta.device)
            for j, d in slots:
                tot = tot + d.logpdf(theta[..., j])
            for ms, ts, exps in table:
                mu, tau = torch.log(theta[..., ms]), theta[..., ts]
                for es in exps:
                    zk = torch.log(theta[..., es])
                    tot = tot - 0.5 * ((zk - mu) / tau) ** 2 \
                        - torch.log(tau) - half_log_2pi
            return tot
        return prior_logpdf, True

    def _joint_chi_fn(self, solver_kw):
        """``chi(theta (N, D)) -> (N,)``: the experiments' summed chi with
        fixed steps, the HMC potential's (``odelib_tpu``'s
        ``_joint_chi_fn``)."""
        from .samplers.joint import _total_chi_fn
        specs, idxs, obs, times, y0s, method, subs = \
            self._device_args(solver_kw)
        total = _total_chi_fn(specs, idxs, obs, times, y0s, method, subs)
        return lambda theta: total(theta)[0]

    def _lhs_thetas(self, samples):
        """(samples, D) LHS draws over the joint priors (a
        ``torch.Generator`` seeded from ``random_seed``), the slots without
        a prior at their current values."""
        dists = self._dists()
        thetas = np.tile(self._current_joint_theta(), (int(samples), 1))
        draw_dims = [j for j, d in enumerate(dists) if d is not None]
        if draw_dims:
            gen = torch.Generator().manual_seed(int(self.random_seed))
            thetas[:, draw_dims] = sample_lhs(
                gen, [self._slot_dist(j) for j in draw_dims],
                int(samples)).numpy()
        return thetas

    def fit_survey(self, samples=1000, **solver_kw) -> pd.DataFrame:
        """LHS over the joint priors (a ``torch.Generator`` seeded from
        ``random_seed``) -> DataFrame[columns..., chi], scored by
        :func:`~odelib_tpu_torch.samplers.joint.joint_survey` in float64
        on the frameworks' device with fixed steps."""
        thetas = self._lhs_thetas(samples)
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
        joint kernel (its twin on a CPU framework), or the XLA joint
        sampler, routed as ``odelib_tpu`` routes on a TPU.

        Chains seed from the best ``chain_inits`` of ``fitsurvey_samples``
        LHS prior draws (sampled with replacement among the lowest chi).
        Returns a DataFrame with the joint columns plus total ``chi``,
        per-experiment ``chi:<name>``, ``iteration``, ``acceptance_ratio``,
        ``chain#`` and ``all_rejected``, one row per recorded joint sample.
        ``use_priors=True`` adds the log prior of every joint slot (a
        shared parameter's from the first framework) to the acceptance in
        the kernel, once per proposal. ``profile=True`` records each
        stage's wall seconds in ``last_profile`` (synchronising the device
        at each boundary) and logs them as the "stage timings:" report.
        ``checkpoint_every`` (with ``checkpoint_path``) runs the joint
        kernel in chunks of that many proposals and persists the chain
        state and records after each to ``<checkpoint_path>.progress``;
        ``resume_from`` (with the same ``checkpoint_every``) continues a
        killed run from that file, bitwise the uninterrupted run's
        posterior, and raises ``ValueError`` for a file of another
        configuration, data or (with ``use_priors``) priors, or one that
        ``odelib_tpu`` wrote. ``until_rhat``/``until_min_ess`` (not with
        checkpointing): after the run, while the pooled posterior's worst
        split-R-hat or least ESS over the walked joint slots misses the
        target, every chain continues from its last state for another
        ``iterations_per_chain`` proposals (a fresh stream, no burn-in),
        at most ``max_extensions`` times (then a warning).
        Routing: ``backend='auto'`` runs the kernel unless a prior (with
        ``use_priors``) has no in-kernel form, an experiment holds
        censored count data or an RHS does not trace; those runs and
        ``backend='xla'`` take the XLA joint MH
        (:func:`~odelib_tpu_torch.samplers.joint.joint_metropolis_hastings`,
        ``..._checkpointed`` with ``checkpoint_every``; float64, chain i
        keyed ``fold_in(PRNGKey(random_seed), i)``, any prior family). A
        stochastic experiment sends every backend but 'pallas' to
        :func:`~odelib_tpu_torch.samplers.joint.joint_pmmh`
        (``n_particles``, ``sde_substeps``, ``sde_method``,
        ``adapt_proposal`` during burn-in; extensions run unadapted);
        'pallas', checkpointing and ``sampler='hmc'`` with one raise the
        reference's ``ValueError``. Hierarchical parameters and
        ``sampler='hmc'`` take the XLA route under 'auto' and 'xla' (the
        pooling density couples slots, which the kernel's per-slot priors
        cannot), and raise ``ValueError`` under 'pallas'. HMC
        (:func:`~odelib_tpu_torch.samplers.hmc.hamiltonian_mc_custom`,
        checkpointed with ``checkpoint_every``) runs over the summed chi
        with ``n_leapfrog``, ``step_size``, ``path_adapt`` (ChEES) and
        ``dense_mass``, keyed by chain 0's key; its posterior has no
        ``chi:<name>`` columns. The arm is logged and names the
        ``chains[<arm>]`` stage of ``last_profile`` ('pallas', 'xla' or
        'pmmh'). ``pallas_tile_chains`` and ``pallas_interpret`` are
        accepted and ignored.
        """
        until = until_rhat is not None or until_min_ess is not None
        if until and sampler != "mh":
            raise ValueError(
                "until_rhat/until_min_ess run-length extension is "
                "supported for sampler='mh'")
        if until and (checkpoint_every is not None
                      or resume_from is not None):
            raise ValueError(
                "until_rhat/until_min_ess cannot be combined with "
                "checkpointing (the extension count is data-dependent)")
        if backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"backend must be 'auto', 'pallas' or 'xla', "
                             f"got {backend!r}")
        if sampler not in ("mh", "hmc"):
            raise ValueError(f"sampler must be 'mh' or 'hmc', got "
                             f"{sampler!r}")
        if self._stoch:
            # a diffusion= experiment routes the fit through joint PMMH:
            # exact chi for the deterministic experiments plus unbiased
            # filter estimates for the stochastic ones
            if sampler == "hmc":
                raise ValueError(
                    "sampler='hmc' needs differentiable likelihoods; "
                    f"stochastic experiment(s) {sorted(self._stoch)} "
                    "score through a (non-differentiable) particle "
                    "filter — use sampler='mh'")
            if backend == "pallas":
                raise ValueError(
                    "backend='pallas' does not support stochastic "
                    "experiments; joint PMMH runs on the XLA backend "
                    "(backend='xla' or 'auto')")
            if checkpoint_every is not None or resume_from is not None:
                raise ValueError(
                    "checkpointing is not supported for joint PMMH; run "
                    "uninterrupted or checkpoint the per-experiment "
                    "fits individually (MCMC(sampler='pmmh', "
                    "checkpoint_every=...))")
        if sampler == "hmc" and backend == "pallas":
            raise ValueError("sampler='hmc' runs on the XLA backend")
        if self.hierarchical and backend == "pallas":
            raise ValueError(
                "backend='pallas' does not support hierarchical "
                "parameters (the pooling prior couples joint slots); "
                "use backend='xla' or 'auto'")
        if checkpoint_every is not None and checkpoint_path is None:
            # resume_from alone is not enough: without a path the resumed
            # run would silently stop persisting
            raise ValueError(
                "checkpoint_every requires checkpoint_path (chain state "
                "is persisted to <checkpoint_path>.progress)")
        if resume_from is not None and checkpoint_every is None:
            raise ValueError(
                "resume_from requires checkpoint_every (and "
                "checkpoint_path) — restate the checkpointing "
                "configuration the run was started with")
        from .ops.priors import kernel_priors_supported
        # odelib_tpu's decision on a TPU: the fused kernel when every
        # prior (with use_priors) has an in-kernel form, every RHS traces
        # and censored data are lognormal or Student-t; else the XLA joint
        # sampler, which 'xla' forces
        fused_ok = (
            (not use_priors or kernel_priors_supported(self._dists()))
            and all(traces(fw._spec) for fw in self.frameworks.values())
            and all(fw._obsdata_fit_host.censor is None
                    or fw._spec.obs_model in ("lognormal", "student_t")
                    for fw in self.frameworks.values()))
        if self._stoch:
            arm = "pmmh"
        elif sampler == "hmc" or self.hierarchical:
            arm = "xla"
        elif backend == "pallas":
            for fw in self.frameworks.values():
                require_kernel_rhs(fw._spec)
            arm = "pallas"
        else:
            arm = "pallas" if backend == "auto" and fused_ok else "xla"
        priors = None
        if use_priors and arm == "pallas":
            from .ops.priors import require_kernel_priors
            priors = require_kernel_priors(self._dists())
        if arm != "pallas":
            for fw in self.frameworks.values():
                require_batched(fw._spec, fw._current_theta()[None],
                                fw.get_inits(), fw._times_fit[0])
            if sampler == "hmc":
                get_logger().info("JointFit.MCMC: joint HMC over the "
                                  "summed chi (samplers/hmc.py)")
            else:
                get_logger().info(
                    "JointFit.MCMC: the XLA joint sampler (samplers/joint.py,"
                    " %s)", f"joint PMMH, {int(n_particles)} particles"
                    if arm == "pmmh" else "joint MH")
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

        # a digest of the data, solver and (with a prior in the target)
        # priors in the resume signature: a resume against edited data
        # must fail
        prior_logpdf, use_priors_eff = self._effective_prior(use_priors)
        config_token = "" if checkpoint_every is None else \
            self._stable_config_token(method, subs,
                                      include_priors=use_priors_eff)

        progress = (None if checkpoint_every is None
                    else checkpoint_path + ".progress")
        if arm == "pallas":
            from .ops.cuda_joint import joint_metropolis_hastings_fused

            def run(th0, seed, burnin, **ck):
                return joint_metropolis_hastings_fused(
                    specs, idxs, obs, times, y0s,
                    torch.as_tensor(np.asarray(th0, np.float32),
                                    device=self.device),
                    seed=seed, nits=nits, burnin=int(burnin),
                    walk_mask=mask, rwalk_std=float(rwalk_std),
                    stepper="rk4" if method == "rk4" else "dopri5",
                    substeps_list=subs, priors=priors, **ck)
            out = run(theta0, int(self.random_seed), burnin,
                      checkpoint_every=checkpoint_every,
                      checkpoint_path=progress, resume_from=resume_from,
                      config_token=config_token)

            def run_more(th_last, salt):
                # a reseed with random_seed + 104729 * salt, no burn-in
                # (odelib_tpu/joint.py:1076-1095)
                return run(th_last, int(self.random_seed) + 104729 * salt, 0)
        else:
            hmc = None if sampler != "hmc" else dict(
                chi_fn=self._joint_chi_fn(solver_kw),
                n_leapfrog=int(n_leapfrog), step_size=float(step_size),
                path_adapt=bool(path_adapt), dense_mass=bool(dense_mass))
            run = self._xla_runner(
                specs, idxs, obs, times, y0s, method, subs, mask,
                nits=nits, rwalk_std=float(rwalk_std),
                prior_logpdf=prior_logpdf, use_priors=use_priors_eff,
                n_particles=int(n_particles), sde_substeps=int(sde_substeps),
                sde_method=str(sde_method), hmc=hmc)
            out = run(theta0, 0, burnin, adapt=bool(adapt_proposal),
                      checkpoint_every=checkpoint_every,
                      checkpoint_path=progress, resume_from=resume_from,
                      config_token=config_token)

            def run_more(th_last, salt):
                # fresh keys fold_in(PRNGKey(seed), salt * 1_000_003 + i),
                # no burn-in; joint PMMH extensions run unadapted
                # (odelib_tpu/joint.py:1097-1135)
                return run(th_last, salt, 0)
        if until:
            from .utils.diagnostics import extend_until
            out = extend_until(
                out, run_more, nits=nits, mask=mask, until_rhat=until_rhat,
                until_min_ess=until_min_ess,
                max_extensions=int(max_extensions), what="joint run")
        stage_done(f"chains[{arm}]")
        posterior = self._posterior_to_df(out, n_chains)
        stage_done("posterior")
        if print_report:
            self._report(posterior)
        stage_done("report")
        if profile:
            self.last_profile = stages
            timer = StageTimer()
            timer.times.update(stages)
            timer.report()
        return posterior

    def _require_deterministic(self, what, drift_only):
        """A joint method whose math assumes deterministic likelihoods
        refuses when any experiment carries process noise, unless opted
        into the drift-only approximation (then it warns)."""
        if not self._stoch:
            return
        if not drift_only:
            raise ValueError(
                f"{what} assumes deterministic likelihoods, but "
                f"experiment(s) {sorted(self._stoch)} carry process "
                "noise (diffusion=...): a single drift trajectory's fit "
                "statistic is not the SDE's marginal likelihood. Use "
                "MCMC() (joint particle-marginal MH), or pass "
                "drift_only=True to run on the drift skeletons (the "
                "diffusion terms are IGNORED).")
        warnings.warn(
            f"{what}: drift_only=True with stochastic experiment(s) "
            f"{sorted(self._stoch)} — diffusion terms are ignored; "
            "treat the result as an analysis of the deterministic "
            "skeletons, not of the SDEs.")

    def fit_map(self, starts=64, steps=500, learning_rate=0.05,
                use_priors=False, static_parameters=(), set_best=True,
                drift_only=False, **solver_kw) -> pd.DataFrame:
        """Multi-start Adam on the joint posterior (``odelib_tpu``'s
        ``JointFit.fit_map``): maximum likelihood over the summed chi, or
        MAP with ``use_priors=True``; hierarchical pooling always enters
        (:meth:`_effective_prior`). The starts are ``starts`` LHS draws
        over the joint priors and the current values, each a lane of every
        experiment's fixed-step solve. Returns the per-start optima
        (columns..., chi, loss, converged) sorted by chi; ``set_best=True``
        pushes the winner into every framework."""
        self._require_deterministic("fit_map", drift_only)
        from .samplers.optimize import map_fit_custom

        cur = self._current_joint_theta()
        thetas = np.concatenate([self._lhs_thetas(starts), cur[None]])
        prior_fn, use_eff = self._effective_prior(use_priors)
        res = map_fit_custom(
            self._joint_chi_fn(solver_kw), thetas, steps=int(steps),
            learning_rate=float(learning_rate),
            walk_mask=self._walk_mask(static_parameters),
            prior_logpdf=prior_fn, use_priors=use_eff, device=self.device)
        df = self._df_from_thetas(res.theta.cpu().numpy())
        df["chi"] = res.chi.cpu().numpy()
        df["loss"] = res.loss.cpu().numpy()
        df["converged"] = res.converged.cpu().numpy()
        df = df.sort_values("chi").reset_index(drop=True)
        if set_best and len(df) and np.isfinite(df["chi"].iloc[0]):
            self.set_best_params(df)
        return df

    def fit_advi(self, steps=800, learning_rate=0.05, n_mc=8,
                 rank="full", draws=1000, use_priors=True,
                 static_parameters=(), resample=False, print_report=True,
                 drift_only=False, **solver_kw) -> pd.DataFrame:
        """Variational (ADVI) joint posterior (``odelib_tpu``'s
        ``JointFit.fit_advi``): a Gaussian over the joint log-parameters
        fitted by ELBO ascent through every experiment's solve, from the
        current values with key ``PRNGKey(random_seed)``; the diagnostics
        in ``df.attrs['advi']`` as :meth:`ModelFramework.fit_advi`'s.
        Returns ``draws`` rows of the joint columns and total ``chi``."""
        self._require_deterministic("fit_advi", drift_only)
        from .samplers.advi import advi_custom, attach_advi_diagnostics

        if rank not in ("full", "diag"):
            raise ValueError(f"rank must be 'full' or 'diag', got {rank!r}")
        cur = self._current_joint_theta()
        mask = self._walk_mask(static_parameters)
        if np.any((cur <= 0) & (mask != 0)):
            raise ValueError(
                "fit_advi needs positive current values on every free "
                "joint dimension; run fit_map (or set parameters) first")
        prior_fn, use_eff = self._effective_prior(use_priors)
        res = advi_custom(
            self._joint_chi_fn(solver_kw), cur, steps=int(steps),
            learning_rate=float(learning_rate), n_mc=int(n_mc),
            full_rank=(rank == "full"), draws=int(draws), walk_mask=mask,
            prior_logpdf=prior_fn, use_priors=use_eff,
            seed=int(self.random_seed), device=self.device)
        df = self._df_from_thetas(res.theta.cpu().numpy())
        df["chi"] = res.chi.cpu().numpy()
        df, khat = attach_advi_diagnostics(
            df, res, seed=self.random_seed, resample=resample,
            label="joint ADVI")
        if print_report:
            report = ["\nJoint ADVI Report (variational posterior)\n"
                      "========================================="]
            for col in self.columns:
                tmpl = self._template(col)
                if tmpl is None:
                    m, s = tstats.rawstats(df[col].to_numpy(float))
                    report.append(f"parameter: {col}\n\tmedian = "
                                  f"{float(m):0.3e}, Standard deviation "
                                  f"= {float(s):0.3e}")
                    continue
                vals = np.stack([np.ravel(np.asarray(v, float))
                                 for v in df[col].to_numpy()])
                for i in range(vals.shape[1]):
                    if tmpl[i] == 0:
                        continue
                    m, s = tstats.rawstats(vals[:, i])
                    report.append(f"parameter: {col}[{i}]\n\tmedian = "
                                  f"{float(m):0.3e}, Standard deviation "
                                  f"= {float(s):0.3e}")
            report.append(f"\nfinal ELBO = {float(res.elbo[-1]):0.4e}, "
                          f"converged = {bool(res.converged)}, "
                          f"khat = {khat:0.3f} "
                          f"({'reliable' if khat < 0.7 else 'UNRELIABLE'})")
            print("\n".join(report))
        return df

    def power_scale_sensitivity(self, posterior, alphas=(0.8, 1.25),
                                threshold=0.05, print_report=True):
        """Prior and likelihood power-scaling sensitivity of a fitted joint
        posterior (``odelib_tpu``'s ``JointFit.power_scale_sensitivity``,
        the mirror of :meth:`ModelFramework.power_scale_sensitivity`): the
        draws are PSIS-reweighted to per-slot ``prior^a`` (each slot's
        prior ``logpdf`` on the frameworks' device) and total ``lik^a``,
        no refit. Hierarchical pooling factors are not perturbed, only the
        slots' priors and hyperpriors. Expects a prior-aware posterior
        (``use_priors=True``, or hierarchical)."""
        from .api_inference import _power_scale_report
        from .utils.sensitivity import power_scale_sensitivity as _ps

        dists = self._dists()
        if all(d is None for d in dists):
            raise ValueError("power_scale_sensitivity needs at least one "
                             "joint slot with a prior distribution")
        finite = posterior[np.isfinite(posterior["chi"].astype(float))]
        thetas = np.asarray(self._thetas_from_df(finite), float)
        chi = finite["chi"].to_numpy(float)
        th = torch.as_tensor(thetas, device=self.device)
        log_prior = torch.zeros_like(th)
        for j, d in enumerate(dists):
            if d is not None:
                log_prior[:, j] = self._slot_dist(j).logpdf(th[:, j])
        log_prior = log_prior.cpu().numpy()
        labels = []
        for lab in self.columns:
            tmpl = self._template(lab)
            if tmpl is None:
                labels.append(lab)
            else:
                labels += [f"{lab}[{i}]" for i in range(tmpl.size)]
        keep = [j for j in range(thetas.shape[1])
                if np.ptp(thetas[:, j]) > 0 and np.all(thetas[:, j] > 0)]
        if not keep:
            raise ValueError("no varying positive slots in the posterior")
        df = _ps(np.log(thetas[:, keep]), -chi, log_prior[:, keep],
                 alphas=tuple(alphas), threshold=float(threshold),
                 labels=[labels[j] for j in keep])
        if print_report:
            print(_power_scale_report(
                df, threshold, "\nJoint power-scaling sensitivity (prior | "
                "likelihood)\n================================================"
                ))
        return df

    def _experiment_posterior(self, posterior, nm):
        """The joint posterior's columns of experiment ``nm``, named by its
        own parameter names."""
        fw = self.frameworks[nm]
        sub = pd.DataFrame(index=posterior.index)
        for p in fw._pnames:
            lab = p if p in self.shared else f"{nm}:{p}"
            sub[p] = posterior[lab]
        return sub

    def posterior_predictive(self, posterior, n_draws=200, ci=0.9,
                             print_report=True, **solver_kw):
        """Posterior predictive check of every experiment (``odelib_tpu``'s
        ``JointFit.posterior_predictive``): each framework's
        :meth:`ModelFramework.posterior_predictive` on its slice of the
        joint posterior. Returns ``{name: result}`` and ``overall`` (the
        observation-weighted coverage, ``n_observations``)."""
        out, n_cov, n_obs = {}, 0.0, 0
        for nm, fw in self.frameworks.items():
            res = fw.posterior_predictive(
                self._experiment_posterior(posterior, nm),
                n_draws=n_draws, ci=ci, print_report=False, **solver_kw)
            out[nm] = res
            k = len(res["summary"])
            n_cov += res["coverage"] * k
            n_obs += k
        coverage = n_cov / max(n_obs, 1)
        out["overall"] = {"coverage": coverage, "n_observations": n_obs}
        if print_report:
            parts = ", ".join(f"{nm}: {out[nm]['coverage']:.1%}"
                              for nm in self.frameworks)
            print(f"joint posterior predictive: {coverage:.1%} of "
                  f"{n_obs} observations inside the {int(ci * 100)}% "
                  f"interval ({parts})")
        return out

    def information_criteria(self, posterior, n_draws=400,
                             print_report=True, **solver_kw):
        """WAIC and PSIS-LOO of every experiment and their pooled totals
        (``odelib_tpu``'s ``JointFit.information_criteria``): per
        experiment :meth:`ModelFramework.information_criteria` on its
        slice; ``overall`` sums the elpd and p terms (the experiments are
        independent given the parameters) and the standard errors in
        quadrature. Prefer the pooling variant with the higher
        ``overall['elpd_loo']``."""
        out, tot = {}, {"elpd_waic": 0.0, "elpd_loo": 0.0,
                        "p_waic": 0.0, "p_loo": 0.0,
                        "se2_waic": 0.0, "se2_loo": 0.0, "n_bad_khat": 0}
        for nm, fw in self.frameworks.items():
            res = fw.information_criteria(
                self._experiment_posterior(posterior, nm),
                n_draws=n_draws, print_report=False, **solver_kw)
            out[nm] = res
            tot["elpd_waic"] += res["waic"]["elpd_waic"]
            tot["p_waic"] += res["waic"]["p_waic"]
            tot["se2_waic"] += res["waic"]["se_elpd_waic"] ** 2
            tot["elpd_loo"] += res["loo"]["elpd_loo"]
            tot["p_loo"] += res["loo"]["p_loo"]
            tot["se2_loo"] += res["loo"]["se_elpd_loo"] ** 2
            tot["n_bad_khat"] += res["loo"]["n_bad_khat"]
        overall = {
            "elpd_waic": tot["elpd_waic"], "p_waic": tot["p_waic"],
            "se_elpd_waic": float(np.sqrt(tot["se2_waic"])),
            "elpd_loo": tot["elpd_loo"], "p_loo": tot["p_loo"],
            "se_elpd_loo": float(np.sqrt(tot["se2_loo"])),
            "n_bad_khat": tot["n_bad_khat"]}
        out["overall"] = overall
        if print_report:
            print(f"joint WAIC: elpd = {overall['elpd_waic']:.2f} "
                  f"(se {overall['se_elpd_waic']:.2f}); joint PSIS-LOO: "
                  f"elpd = {overall['elpd_loo']:.2f} "
                  f"(se {overall['se_elpd_loo']:.2f}), bad khat: "
                  f"{overall['n_bad_khat']}")
        return out

    def diagnostics(self, posterior) -> pd.DataFrame:
        """Convergence diagnostics (mean, std, median, ess, ess_per_draw,
        rhat) of every joint column, hyperparameters included: the table
        of :meth:`ModelFramework.diagnostics` over the joint posterior."""
        from .utils.diagnostics import summarize
        return summarize(posterior, list(self.columns))

    def _joint_prior_logpdf(self):
        """``prior_logpdf(theta (N, D)) -> (N,)`` for the XLA joint
        samplers: each joint slot's prior log density (a shared
        parameter's from the first framework; an array parameter's on its
        non-zero template entries), added in slot order (``odelib_tpu``'s
        ``_joint_prior_logpdf``); any family."""
        slots = [(j, self._slot_dist(j)) for j, d in enumerate(self._dists())
                 if d is not None]

        def prior_logpdf(theta):
            tot = torch.zeros(theta.shape[:-1], dtype=theta.dtype,
                              device=theta.device)
            for j, d in slots:
                tot = tot + d.logpdf(theta[..., j])
            return tot
        return prior_logpdf

    def _xla_runner(self, specs, idxs, obs, times, y0s, method, subs, mask,
                    *, nits, rwalk_std, prior_logpdf, use_priors,
                    n_particles, sde_substeps, sde_method, hmc=None):
        """``run(theta0, salt, burnin, adapt=False, **checkpointing)``: the
        XLA joint sampler (``odelib_tpu/joint.py``'s xla branch) on the
        frameworks' device in float64, chain i keyed
        ``fold_in(PRNGKey(random_seed), salt * 1_000_003 + i)``: joint PMMH
        with a stochastic experiment, HMC over ``hmc['chi_fn']`` with
        ``hmc`` (its knobs), else joint MH (checkpointed with
        ``checkpoint_every``)."""
        from . import random as jr
        from . import samplers
        from .samplers import joint as sj
        from .samplers.pf import obs_blocks
        common = dict(walk_mask=mask, rwalk_std=rwalk_std, method=method,
                      substeps_list=subs, use_priors=bool(use_priors),
                      prior_logpdf=prior_logpdf)
        base = jr.PRNGKey(int(self.random_seed), device=self.device)

        def run(theta0, salt, burnin, adapt=False, checkpoint_every=None,
                **ck):
            th0 = torch.as_tensor(np.asarray(theta0, np.float64),
                                  device=self.device)
            keys = jr.fold_in(base, salt * 1_000_003 + torch.arange(
                len(th0), device=self.device))
            args = (specs, idxs, obs, times, y0s, th0, keys)
            if hmc is not None:
                kw = dict(hmc, nits=nits, burnin=burnin, walk_mask=mask,
                          use_priors=bool(use_priors),
                          prior_logpdf=prior_logpdf)
                chi_fn = kw.pop("chi_fn")
                if checkpoint_every is not None:
                    return samplers.hamiltonian_mc_custom_checkpointed(
                        chi_fn, th0, keys,
                        checkpoint_every=int(checkpoint_every), **ck, **kw)
                return samplers.hamiltonian_mc_custom(chi_fn, th0, keys,
                                                      **kw)
            if self._stoch:
                blocks = tuple(obs_blocks(fw._obsdata_fit_host)
                               if nm in self._stoch else None
                               for nm, fw in self.frameworks.items())
                return sj.joint_pmmh(
                    *args, stoch_blocks=blocks, nits=nits, burnin=burnin,
                    n_particles=n_particles, sde_substeps=sde_substeps,
                    sde_method=sde_method, adapt_proposal=adapt, **common)
            if checkpoint_every is not None:
                return sj.joint_metropolis_hastings_checkpointed(
                    *args, nits=nits, burnin=burnin,
                    checkpoint_every=int(checkpoint_every), **ck, **common)
            return sj.joint_metropolis_hastings(*args, nits=nits,
                                                burnin=burnin, **common)
        return run

    def _stable_config_token(self, method, subs, include_priors=False):
        """A process-stable sha1 of what the joint target bakes in: the
        experiment order, the joint columns, the solver method and
        substeps, the pooling layout, each experiment's inits, time grid,
        observation model and doses and observation arrays, and with
        ``include_priors`` each parameter's prior family and
        hyperparameters (``odelib_tpu``'s ``JointFit._stable_config_token``
        in the port's terms). Part of a checkpoint's signature, so a resume
        against edited data or priors raises."""
        from .ops.chunked import digest_priors
        h = hashlib.sha1()
        h.update(repr((tuple(self.frameworks), tuple(self.columns),
                       method, subs, tuple(self.hierarchical))).encode())
        for fw in self.frameworks.values():
            h.update(np.asarray(fw.get_inits(), float).tobytes())
            h.update(np.asarray(fw._times_fit, float).tobytes())
            h.update(repr((fw._spec.obs_model, fw._spec.obs_param,
                           fw._spec.dose_events, fw._spec.pshapes,
                           fw._spec.forcings)).encode())
            for leaf in fw._obsdata_fit_host:
                if leaf is not None:
                    h.update(np.asarray(leaf).tobytes())
        if include_priors:
            for fw in self.frameworks.values():
                digest_priors(h, fw.parameters)
            for lab, hyp in sorted(self._hyper_priors.items()):
                h.update(repr((lab, repr(hyp))).encode())
        return h.hexdigest()

    def _posterior_to_df(self, out, n_chains):
        """Records -> the joint posterior DataFrame, one block of rows per
        chain (built column-wise; the same frame as a per-chain concat)."""
        theta = out.theta[:n_chains].cpu().numpy()          # (C, R, D)
        C, R, _ = theta.shape
        # HMC's potential is the summed chi: no per-experiment parts
        parts = out.chi_parts[:n_chains].cpu().numpy() \
            if hasattr(out, "chi_parts") else None
        ar = out.acceptance_ratio[:n_chains].cpu().numpy()
        all_rejected = ar[:, -1] == 0.0 if R else np.zeros(C, bool)
        cols = {}
        for lab in self.columns:
            off, shp = self._col_offsets[lab], self._col_shapes[lab]
            if shp:     # a cell holds the parameter's array
                n = int(np.prod(shp))
                cols[lab] = list(theta[:, :, off:off + n].astype(
                    np.float64).reshape((C * R,) + tuple(shp)))
            else:
                cols[lab] = theta[:, :, off].reshape(-1).astype(np.float64)
        cols["chi"] = out.chi[:n_chains].cpu().numpy().reshape(-1)
        for k, nm in enumerate(self.frameworks if parts is not None else ()):
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
            if self._col_shapes[col]:
                median, std = tstats.rawstats(np.stack(
                    posterior[col].to_numpy()).astype(float), dim=0)
                report.append(f"parameter: {col}\n\tmedian = "
                              f"{median.numpy()}, Standard deviation "
                              f"= {std.numpy()}")
                continue
            median, std = tstats.rawstats(np.array(posterior[col], float))
            report.append(f"parameter: {col}\n\tmedian = "
                          f"{float(median):0.3e}, Standard "
                          f"deviation = {float(std):0.3e}")
        best = posterior.loc[posterior["chi"].idxmin()]
        report.append("\nBest joint sample:")
        if all(f"chi:{nm}" in best for nm in self.frameworks):
            report.append("\tChi = {:0.3e} ({})".format(
                best["chi"], ", ".join(
                    f"chi:{nm} = {best[f'chi:{nm}']:0.3e}"
                    for nm in self.frameworks)))
        else:
            report.append("\tChi = {:0.3e}".format(best["chi"]))
        print("\n".join(report))

    def set_best_params(self, posterior):
        """Push the min-chi joint sample back into every framework, and
        keep its hyperparameter values."""
        best = posterior.loc[posterior["chi"].idxmin()]
        for lab in self._hyper_vals:
            if lab in best:
                self._hyper_vals[lab] = float(best[lab])
        for nm, fw in self.frameworks.items():
            vals = {}
            for p, shp in zip(fw._pnames, fw._spec.pshapes):
                v = best[p if p in self.shared else f"{nm}:{p}"]
                vals[p] = np.asarray(v, float).reshape(shp) if shp \
                    else float(v)
            fw.set_parameters(**vals)
        return best
