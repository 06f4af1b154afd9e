"""Samplers: Latin-hypercube draws, the batched and joint surveys, and the
reference's XLA samplers in torch (MH and its checkpointed run, the
Goodman-Weare ensemble, parallel tempering with its checkpointed run and
``tune_ladder``, the particle filter's PMMH with its checkpointed run and
``tune_particles``, the joint MH and joint PMMH, HMC over a model or any
differentiable chi with their checkpointed runs, adaptive Metropolis),
multi-start Adam (``map_fit``), ADVI and tempered SMC, with the record
structures and the tempering bookkeeping."""
from .advi import (ADVIResult, advi, advi_custom, psis_weights,
                   resample_indices)
from .amh import adaptive_metropolis
from .ensemble import ensemble_mh
from .joint import (JointOutput, joint_metropolis_hastings,
                    joint_metropolis_hastings_checkpointed, joint_pmmh,
                    joint_survey)
from .hmc import (hamiltonian_mc, hamiltonian_mc_checkpointed,
                  hamiltonian_mc_custom, hamiltonian_mc_custom_checkpointed)
from .lhs import lhs_unit, sample_lhs
from .mh import (MHOutput, metropolis_hastings,
                 metropolis_hastings_checkpointed, survey)
from .optimize import MAPResult, map_fit, map_fit_custom
from .pf import (PMMHOutput, obs_blocks, particle_filter_chi, pmmh,
                 pmmh_checkpointed, tune_particles)
from .pt import (parallel_tempering, parallel_tempering_checkpointed,
                 swap_attempts, tune_ladder)
from .smc import SMCOutput, smc_sample

__all__ = ["lhs_unit", "sample_lhs", "MHOutput", "metropolis_hastings",
           "metropolis_hastings_checkpointed", "survey",
           "parallel_tempering", "ensemble_mh",
           "joint_metropolis_hastings",
           "joint_metropolis_hastings_checkpointed", "joint_pmmh",
           "joint_survey", "JointOutput",
           "pmmh", "PMMHOutput", "particle_filter_chi", "obs_blocks",
           "pmmh_checkpointed", "tune_particles",
           "parallel_tempering_checkpointed", "tune_ladder",
           "swap_attempts", "hamiltonian_mc", "hamiltonian_mc_checkpointed",
           "hamiltonian_mc_custom", "hamiltonian_mc_custom_checkpointed",
           "adaptive_metropolis", "map_fit", "map_fit_custom", "MAPResult",
           "advi", "advi_custom", "ADVIResult", "psis_weights",
           "resample_indices", "smc_sample", "SMCOutput"]
