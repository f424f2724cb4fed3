"""scfgp — sparsely-correlated Fourier-feature Gaussian processes on GPUs.

A from-scratch JAX/XLA framework with the capability surface of the
reference ``MaxInGaussian/SCFGP`` (Theano): low-rank trig Fourier feature GP
regression with a regularized marginal-likelihood objective, an optimizer zoo,
automatic data scaling, an early-stopping training harness, checkpointing,
benchmark experiments — plus accelerator extensions the reference lacks:
data-parallel training over device meshes via psum-ed sufficient statistics,
a device-fused training loop, and chain-parallel HMC/NUTS.
"""

import jax as _jax

# f32 must MEAN f32: on an H100, jax's default matmul precision lowers f32
# dots to TF32 tensor-core GEMMs (10 mantissa bits).  Reduced-precision
# GEMMs break the co2 composite model (docs/RESULTS.md precision section),
# and the reference runs float64 Theano (``reference:
# SCFGP/SCFGP.py:95,138``), so metric parity requires true f32 as the
# floor.  Explicitly requested reduced precision stays available
# (``SCFGP(mm_dtype=...)`` / the "auto" dispatch, ops/dispatch.py) on the
# two O(N K^2) GEMMs only; the DEFAULT is correct.  Respect a user's own
# setting if present.
if _jax.config.jax_default_matmul_precision is None:
    _jax.config.update("jax_default_matmul_precision", "highest")

from .models.params import (SCFGPParams, init_params, pack_params,
                            unpack_params, num_params)
from .models.objective import (SufficientStats, Posterior, fourier_features,
                               sufficient_stats, solve_posterior, loss_fn,
                               loss_and_grad, predict_f)
from .data.scaler import Scaler
from .models.model import SCFGP, fit_fast_batch
from .utils.visualizer import Visualizer
from .bayes import (hmc_sample, nuts_sample, fit_vi, vi_sample,
                    make_logposterior, predictive_mixture)

__version__ = "0.1.0"

__all__ = [
    "SCFGP", "fit_fast_batch", "Scaler", "Visualizer",
    "SCFGPParams", "init_params", "pack_params", "unpack_params", "num_params",
    "SufficientStats", "Posterior", "fourier_features", "sufficient_stats",
    "solve_posterior", "loss_fn", "loss_and_grad", "predict_f",
]
