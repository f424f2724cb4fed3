"""Stochastic-gradient Langevin dynamics (SGLD / pSGLD) over SCFGP
hyperparameters — the large-N member of the chain-parallel sampler family.

HMC/NUTS (``bayes/hmc.py``, ``bayes/nuts.py``) evaluate the FULL-data
gradient per leapfrog step; with the streaming objective that is exact at
any N but costs O(N) per step.  SGLD (Welling & Teh 2011) steps on an
N-scaled minibatch gradient plus injected Gaussian noise:

    theta'  =  theta + (eps/2) * G * grad_est(theta) + sqrt(eps * G) * xi

so the per-step cost is O(batch) — the sampler analog of the reference's
own minibatch training mode.  Two estimator modes:

  * ``batch``: ``grad_est`` = grad of ``-0.5 * N * cost(theta; minibatch)``
    (``make_logposterior(..., n_scale=N)``).  HONESTY NOTE: the SCFGP
    marginal-likelihood cost does NOT decompose over rows (the Gram sits
    inside a logdet, ``reference: SCFGP/SCFGP.py:104-128``), so the
    minibatch gradient is the standard scaled-batch approximation — the
    exact semantics of the reference's ``optimize(nbatches>1)`` path
    (``SCFGP.py:226-235``), not an unbiased estimator of the full-data
    gradient.  As batch -> N it converges to exact (unadjusted) Langevin.
  * ``full``: the full-data gradient each step (optionally through the
    O(block)-memory streaming objective) = ULA, whose only bias is the
    eps-discretization (no Metropolis correction; shrink eps to trade
    speed for bias).

``preconditioner="rmsprop"`` is pSGLD (Li et al. 2016): a per-coordinate
RMSProp metric G = 1/(lambda + sqrt(v)) shared across chains, which handles
the SCFGP posterior's wildly different coordinate scales (amplitudes vs
D*S frequency entries) without a hand-tuned mass matrix.  The Gamma(theta)
curvature term is dropped, as is standard.

Device shape: chains are a (C, P) batch vmapped through one gradient —
C posterior evaluations share every GEMM — and all steps run
inside one ``lax.scan`` jit.  One minibatch gather per step is shared by
all chains (a (B,) random-index gather from HBM; chains stay independent
trajectories because the injected noise dominates step-to-step coupling).
Thinning happens inside the scan so only (num_samples, C, P) draws are
ever materialized.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class SGLDResult(NamedTuple):
    samples: jax.Array          # (num_samples, chains, P) thinned draws
    logdensities: jax.Array     # (num_samples, chains) estimator values,
    #                             minibatch-noisy in batch mode and lagged
    #                             ONE step: value at the position the kept
    #                             draw was stepped FROM (the gradient eval
    #                             is pre-update; re-evaluating at the kept
    #                             draw would double the per-draw cost at
    #                             thin=1).  Fine for diagnostics traces.
    step_size: jax.Array        # () final step size after decay
    precond: jax.Array          # (P,) final preconditioner diagonal G
    nonfinite: jax.Array = None  # () count of non-finite proposals rejected
    # (q, v, t, bad) full sampler carry — pass back via ``init_carry=`` to
    # continue the chain exactly across bounded executions
    # (bayes/segmented.py; the step-index t keeps the decay schedule and
    # the RMSProp state v keeps the preconditioner).
    final_carry: tuple = None


def make_minibatch_value_and_grad(X, y, D, S, M, batch_size: int,
                                  basis_fn=None,
                                  streaming_block: int = 0,
                                  mm_dtype=None,
                                  mm_precision=None) -> Callable:
    """Build ``(q, key) -> (vals, grads)`` over (C, P) positions.

    ``batch_size > 0``: per call, draw B row indices uniformly with
    replacement (static shape, one gather shared by all chains) and return
    the N-scaled minibatch log-posterior value/grad.  ``batch_size == 0``:
    the full-data gradient (ULA mode); ``streaming_block`` then routes the
    cost through the O(block)-memory objective for N beyond HBM.
    """
    from .predictive import make_logposterior

    n = X.shape[0]
    if batch_size and batch_size < n:
        def value_and_grad(q, key):
            idx = jax.random.randint(key, (int(batch_size),), 0, n)
            Xb, yb = X[idx], y[idx]
            lp = make_logposterior(Xb, yb, D, S, M, basis_fn=basis_fn,
                                   n_scale=n, mm_dtype=mm_dtype,
                                   mm_precision=mm_precision)
            return jax.vmap(jax.value_and_grad(lp))(q)
    else:
        lp = make_logposterior(X, y, D, S, M, basis_fn=basis_fn,
                               streaming_block=streaming_block,
                               mm_dtype=mm_dtype,
                               mm_precision=mm_precision)

        def value_and_grad(q, key):
            del key
            return jax.vmap(jax.value_and_grad(lp))(q)
    return value_and_grad


def sgld_sample(value_and_grad_fn: Callable, init_positions: jax.Array,
                key: jax.Array, num_warmup: int = 500,
                num_samples: int = 500, step_size: float = 1e-6,
                step_decay: float = 0.0, thin: int = 1,
                preconditioner: str = "rmsprop",
                precond_alpha: float = 0.99,
                precond_lambda: float = 1e-5,
                init_carry: tuple = None) -> SGLDResult:
    """Run C chains of (p)SGLD; fully jitted, one scan.

    ``value_and_grad_fn(q, key) -> (vals (C,), grads (C, P))`` — from
    ``make_minibatch_value_and_grad`` or any custom estimator.
    ``step_size`` decays as ``eps_t = eps0 * (1 + t)**(-step_decay)``
    (Welling & Teh's polynomial schedule; 0.0 = constant, the common
    practical choice).  ``preconditioner``: "rmsprop" (pSGLD) or "none".
    Non-finite proposals are rejected in place (the chain keeps its current
    position) and counted — the SGLD analog of HMC's divergence counter —
    and non-finite gradients are masked out of the shared preconditioner
    update so one diverging chain cannot poison the metric for the rest.
    Returned ``logdensities`` lag the kept draws by one step (see
    ``SGLDResult``).
    """
    if preconditioner not in ("rmsprop", "none"):
        raise ValueError("preconditioner must be 'rmsprop' or 'none'")
    C, P = init_positions.shape
    dtype = init_positions.dtype
    eps0 = jnp.asarray(step_size, dtype)
    use_pre = preconditioner == "rmsprop"
    alpha = jnp.asarray(precond_alpha, dtype)
    lam = jnp.asarray(precond_lambda, dtype)

    def precond_of(v):
        if not use_pre:
            return jnp.ones((P,), dtype)
        return 1.0 / (lam + jnp.sqrt(v))

    def step(carry, key_t):
        q, v, t, bad = carry
        kb, kn = jax.random.split(key_t)
        vals, grads = value_and_grad_fn(q, kb)
        if use_pre:
            # Shared metric: mean squared gradient across chains keeps one
            # (P,) preconditioner (the cross-chain collective under a
            # sharded chain axis, like HMC's shared mass matrix).
            # Non-finite gradients are masked OUT of the v update: the
            # shared preconditioner must stay finite even when one chain
            # diverges, else a single NaN gradient permanently poisons v
            # and freezes ALL chains (every subsequent proposal non-finite
            # and rejected) — reproduced on CPU, ADVICE r3 medium.
            g_ok = jnp.all(jnp.isfinite(grads), axis=1)          # (C,)
            g2 = jnp.where(g_ok[:, None], grads * grads, 0.0)
            n_ok = jnp.sum(g_ok.astype(v.dtype))
            v_upd = alpha * v + (1.0 - alpha) * (
                jnp.sum(g2, axis=0) / jnp.maximum(n_ok, 1.0))
            v = jnp.where(n_ok > 0, v_upd, v)
        g = precond_of(v)[None, :]
        eps = eps0 * (1.0 + t) ** (-jnp.asarray(step_decay, dtype))
        noise = jax.random.normal(kn, q.shape, dtype)
        q_new = q + 0.5 * eps * g * grads + jnp.sqrt(eps * g) * noise
        ok = jnp.all(jnp.isfinite(q_new), axis=1)
        q = jnp.where(ok[:, None], q_new, q)
        bad = bad + jnp.sum(~ok).astype(bad.dtype)
        return (q, v, t + 1.0, bad), (vals, eps)

    keys = jax.random.split(key, num_warmup + num_samples * thin)
    if init_carry is not None:
        # Bounded-execution continuation (pass a previous result's
        # final_carry with num_warmup=0): v/t/bad carry over exactly.
        carry = init_carry
    else:
        v0 = jnp.zeros((P,), dtype)
        carry = (init_positions, v0, jnp.zeros((), dtype),
                 jnp.zeros((), jnp.int32))
    if num_warmup:
        carry, _ = jax.lax.scan(step, carry, keys[:num_warmup])

    def outer(carry, key_block):
        carry, (vals, eps) = jax.lax.scan(step, carry, key_block)
        q = carry[0]
        return carry, (q, vals[-1], eps[-1])

    key_blocks = keys[num_warmup:].reshape(num_samples, thin, -1)
    carry, (samples, lds, epss) = jax.lax.scan(outer, carry, key_blocks)
    q, v, _, bad = carry
    return SGLDResult(samples=samples, logdensities=lds,
                      step_size=epss[-1], precond=precond_of(v),
                      nonfinite=bad, final_carry=carry)
