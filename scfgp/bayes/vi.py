"""Mean-field Gaussian variational inference over SCFGP hyperparameters.

Maximizes the reparameterized ELBO

    ELBO(mu, log_sigma) = E_{eps~N(0,I)}[ logpost(mu + sigma*eps) ] + H(q)

with the entropy ``H(q) = sum(log_sigma) + P/2 log(2 pi e)``, by adam on
(mu, log_sigma).  Monte-Carlo samples of the expectation are vmapped — the
K samples batch through the NLML GEMMs together, and the sample
axis can be sharded like HMC chains.  New capability beyond the MAP-only
reference (SURVEY.md §2.4).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..opt.optimizers import adam, tree_add


class VIResult(NamedTuple):
    mu: jax.Array
    log_sigma: jax.Array
    elbo_history: jax.Array


def fit_vi(logdensity_fn: Callable, init_position: jax.Array,
           key: jax.Array, num_steps: int = 500, num_mc_samples: int = 8,
           learning_rate: float = 0.01,
           init_log_sigma: float = -3.0) -> VIResult:
    """Fit q(theta) = N(mu, diag(sigma^2)) to exp(logdensity)."""
    P = init_position.shape[0]
    mu0 = init_position
    ls0 = jnp.full((P,), init_log_sigma, init_position.dtype)

    ld_batch = jax.vmap(logdensity_fn)
    tx = adam(learning_rate=learning_rate, beta1=0.9, beta2=0.999,
              epsilon=1e-8)

    def neg_elbo(params, key):
        mu, log_sigma = params
        eps = jax.random.normal(key, (num_mc_samples, P), mu.dtype)
        theta = mu[None, :] + jnp.exp(log_sigma)[None, :] * eps
        expected_ld = jnp.mean(ld_batch(theta))
        entropy = jnp.sum(log_sigma) + 0.5 * P * (1.0 + jnp.log(2 * jnp.pi))
        return -(expected_ld + entropy)

    def step(carry, key):
        params, opt_state = carry
        loss, grads = jax.value_and_grad(neg_elbo)(params, key)
        delta, opt_state = tx.update(grads, opt_state, params)
        params = tree_add(params, delta)
        return (params, opt_state), -loss

    keys = jax.random.split(key, num_steps)
    (params, _), elbos = jax.lax.scan(
        step, ((mu0, ls0), tx.init((mu0, ls0))), keys)
    mu, log_sigma = params
    return VIResult(mu=mu, log_sigma=log_sigma, elbo_history=elbos)


def vi_sample(result: VIResult, key: jax.Array, num_samples: int):
    """Draw posterior samples from the fitted mean-field Gaussian."""
    eps = jax.random.normal(key, (num_samples, result.mu.shape[0]),
                            result.mu.dtype)
    return result.mu[None, :] + jnp.exp(result.log_sigma)[None, :] * eps


class VISamplerResult(NamedTuple):
    """fit_vi + vi_sample packaged in the chain-sampler result convention
    (samples (num_samples, C, P)) so ``SCFGP.fit_bayes(sampler='vi')`` slots
    in next to HMC/NUTS/tempered."""

    samples: jax.Array       # (num_samples, C, P)
    logdensities: jax.Array  # (num_samples, C) logpost at the draws
    accept_rate: jax.Array   # () == 1.0 (independent reparameterized draws)
    elbo: jax.Array          # () final ELBO
    mu: jax.Array            # (P,) variational mean
    log_sigma: jax.Array     # (P,) variational log std


def vi_posterior_sample(logdensity_fn: Callable, init_positions: jax.Array,
                        key: jax.Array, num_warmup: int = 500,
                        num_samples: int = 500,
                        learning_rate: float = 0.01,
                        init_log_sigma: float = -3.0) -> VISamplerResult:
    """Chain-convention VI: optimize the ELBO for ``num_warmup`` steps (the
    warmup-budget analog), MC samples batched over the C chain inits, then
    draw ``num_samples`` x C posterior samples."""
    C, P = init_positions.shape
    res = fit_vi(logdensity_fn, jnp.mean(init_positions, axis=0),
                 key, num_steps=num_warmup, num_mc_samples=max(C, 2),
                 learning_rate=learning_rate,
                 init_log_sigma=init_log_sigma)
    draws = vi_sample(res, jax.random.fold_in(key, 1),
                      num_samples * C).reshape(num_samples, C, P)
    lds = jax.vmap(jax.vmap(logdensity_fn))(draws)
    return VISamplerResult(samples=draws, logdensities=lds,
                           accept_rate=jnp.ones((), draws.dtype),
                           elbo=res.elbo_history[-1],
                           mu=res.mu, log_sigma=res.log_sigma)
