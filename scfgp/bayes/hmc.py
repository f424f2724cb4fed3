"""Chain-parallel Hamiltonian Monte Carlo over SCFGP hyperparameters.

New capability beyond the reference (which is MAP-only — its sole Bayesian
element is the KL penalty, ``reference: SCFGP/SCFGP.py:94,114-117,127``;
SURVEY.md §2.4 "chain parallel").  Design:

  * the target is the flat hyperparameter vector (``pack_params`` layout), so
    one ``(chains, P)`` position tensor drives everything;
  * chains are ``vmap``-ed — on one device they batch through one GEMM
    (C parallel NLML evaluations share every matmul), and the chain axis can
    be sharded across devices with ``NamedSharding`` so the same code runs
    chain-parallel on several devices;
  * step size is adapted by dual averaging driven by the MEAN acceptance
    probability across ALL chains (``jnp.mean`` over the chain axis — under
    a sharded chain axis XLA lowers it to a cross-chip all-reduce, which is
    the "cross-chain adaptation via collectives" design), and a shared
    diagonal mass matrix is estimated by Welford accumulation over all
    chains' warmup draws;
  * everything is ``lax.scan``-stepped inside one jit: no per-iteration host
    round trips.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


# A transition is "divergent" when the leapfrog energy error exceeds this
# (Stan's convention; same constant as nuts.MAX_DELTA_ENERGY) or is
# non-finite — the integrator left the region where the step size is stable.
MAX_DELTA_ENERGY = 1000.0


class DualAveragingState(NamedTuple):
    """Nesterov dual averaging for log step size (Hoffman & Gelman 2014)."""

    log_eps: jax.Array
    log_eps_avg: jax.Array
    h_avg: jax.Array
    t: jax.Array
    mu: jax.Array


def da_init(eps0: float, dtype=jnp.float32) -> DualAveragingState:
    log_eps0 = jnp.log(jnp.asarray(eps0, dtype))
    return DualAveragingState(
        log_eps=log_eps0,
        log_eps_avg=log_eps0,
        h_avg=jnp.zeros((), dtype),
        t=jnp.zeros((), dtype),
        mu=(jnp.log(10.0) + log_eps0).astype(dtype),
    )


def da_update(state: DualAveragingState, accept_prob: jax.Array,
              target: float = 0.8, gamma: float = 0.05, t0: float = 10.0,
              kappa: float = 0.75) -> DualAveragingState:
    t = state.t + 1.0
    h_avg = (1.0 - 1.0 / (t + t0)) * state.h_avg + (
        target - accept_prob) / (t + t0)
    log_eps = state.mu - jnp.sqrt(t) / gamma * h_avg
    eta = t ** (-kappa)
    log_eps_avg = eta * log_eps + (1.0 - eta) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, h_avg, t, state.mu)


class WelfordState(NamedTuple):
    count: jax.Array
    mean: jax.Array
    m2: jax.Array


def welford_init(dim: int, dtype=jnp.float32) -> WelfordState:
    return WelfordState(jnp.zeros((), dtype), jnp.zeros(dim, dtype),
                        jnp.zeros(dim, dtype))


def welford_add_batch(state: WelfordState, xs: jax.Array) -> WelfordState:
    """Add a (chains, P) batch of draws (all chains feed ONE shared mass).

    Vectorized Chan-et-al parallel merge (no per-chain sequential scan —
    keeps the compiled sampler program small)."""
    nb = jnp.asarray(xs.shape[0], xs.dtype)
    mb = jnp.mean(xs, axis=0)
    m2b = jnp.sum((xs - mb[None, :]) ** 2, axis=0)
    n = state.count + nb
    delta = mb - state.mean
    mean = state.mean + delta * nb / n
    m2 = state.m2 + m2b + delta * delta * state.count * nb / n
    return WelfordState(n, mean, m2)


def welford_variance(state: WelfordState, reg: float = 1e-3) -> jax.Array:
    var = state.m2 / jnp.maximum(state.count - 1.0, 1.0)
    # Stan-style shrinkage toward unit scale for small sample counts.
    w = state.count / (state.count + 5.0)
    return w * var + (1.0 - w) * reg


def leapfrog(logdensity_grad: Callable, position, momentum, eps, inv_mass,
             num_steps: int, init_ld_grad=None):
    """Leapfrog integrator with gradient caching; (chains, P) tensors.

    The second half-kick's gradient at q_new IS the next step's first
    half-kick gradient, so each step needs ONE new gradient evaluation —
    L+1 per trajectory instead of the naive 2L (and the caller's endpoint
    log densities come free: pass ``init_ld_grad=(ld0, g0)`` and read the
    final ld from the return).  Gradients dominate HMC cost (each is a
    full NLML backward pass), so this halves the per-draw FLOPs with a
    mathematically identical trajectory (same values, same op sequence —
    measured bitwise-equal draws on CPU, tests/test_bayes.py moments).

    Returns ``(q, p, ld_final)``.
    """
    if num_steps == 0:
        # Degenerate identity trajectory (no scan output to index into);
        # callers like a dynamic-L wrapper may legitimately request L=0.
        if init_ld_grad is None:
            ld0, _ = logdensity_grad(position)
        else:
            ld0, _ = init_ld_grad
        return position, momentum, ld0

    if init_ld_grad is None:
        _, g0 = logdensity_grad(position)
    else:
        _, g0 = init_ld_grad

    im = inv_mass if inv_mass.ndim == 2 else inv_mass[None, :]  # (C|1, P)
    e = eps if jnp.ndim(eps) == 0 else eps[:, None]             # () | (C,1)

    def body(carry, _):
        q, p, g = carry
        p = p + 0.5 * e * g
        q = q + e * im * p
        ld, g = logdensity_grad(q)
        p = p + 0.5 * e * g
        return (q, p, g), ld
    (q, p, _), lds = jax.lax.scan(body, (position, momentum, g0), None,
                                  length=num_steps)
    return q, p, lds[-1]


class HMCResult(NamedTuple):
    samples: jax.Array       # (num_samples, chains, P)
    logdensities: jax.Array  # (num_samples, chains)
    accept_rate: jax.Array   # ()
    step_size: jax.Array     # ()
    inv_mass: jax.Array      # (P,)
    # () count over the sampling phase (energy error > MAX_DELTA_ENERGY or
    # non-finite).  Default None, NOT a jnp literal: a module-level jnp call
    # would initialise the XLA backend at import and break
    # jax.distributed.initialize (tests/test_multihost.py).
    divergences: jax.Array = None
    # (chains, P) final chain positions — the resume point for segmented
    # execution (bayes/segmented.py).
    final_positions: jax.Array = None
    # (DualAveragingState, WelfordState) adaptation carry after the warmup
    # steps this call ran — pass back via ``warmup_state=`` to continue
    # warmup across bounded executions.  None when warmup was skipped.
    warmup_state: tuple = None


def make_hmc_transition(logdensity_fn: Callable, num_integration_steps: int):
    """Build one jittable HMC transition ``(q, key, eps, inv_mass) ->
    (q', logdens, accept_probs, divergent)`` over (chains, P) positions.

    Exposed separately so callers can host-loop transitions with adaptation
    outside the jit — a small compiled program where one giant fused
    sampler program is too much for the compiler; ``hmc_sample`` fuses
    everything instead.
    """
    vg = jax.vmap(jax.value_and_grad(logdensity_fn))

    def kinetic(p, inv_mass):
        im = inv_mass if inv_mass.ndim == 2 else inv_mass[None, :]
        return 0.5 * jnp.sum(p * p * im, axis=1)

    def transition(q, key, eps, inv_mass):
        C = q.shape[0]
        k1, k2 = jax.random.split(key)
        im = inv_mass if inv_mass.ndim == 2 else inv_mass[None, :]
        mass_sqrt = 1.0 / jnp.sqrt(im)
        p0 = jax.random.normal(k1, q.shape, q.dtype) * mass_sqrt
        ld0, g0 = vg(q)
        h0 = -ld0 + kinetic(p0, inv_mass)
        q1, p1, ld1 = leapfrog(vg, q, p0, eps, inv_mass,
                               num_integration_steps,
                               init_ld_grad=(ld0, g0))
        h1 = -ld1 + kinetic(p1, inv_mass)
        delta = h1 - h0
        div = jnp.logical_or(~jnp.isfinite(delta), delta > MAX_DELTA_ENERGY)
        log_accept = jnp.minimum(0.0, -delta)
        log_accept = jnp.where(jnp.isfinite(log_accept), log_accept, -jnp.inf)
        u = jax.random.uniform(k2, (C,))
        accept = jnp.log(u) < log_accept
        q_next = jnp.where(accept[:, None], q1, q)
        ld_next = jnp.where(accept, ld1, ld0)
        return q_next, ld_next, jnp.exp(log_accept), div

    return transition


def hmc_sample_host_looped(logdensity_fn: Callable,
                           init_positions: jax.Array, key: jax.Array,
                           num_warmup: int = 500, num_samples: int = 500,
                           num_integration_steps: int = 16,
                           init_step_size: float = 0.01,
                           target_accept: float = 0.8) -> HMCResult:
    """Same sampler as ``hmc_sample`` with the transition jitted but the
    adaptation loop on host: tiny compiled program, one dispatch per
    transition.  Use when the fused program is too large to compile."""
    import numpy as np

    C, P = init_positions.shape
    dtype = init_positions.dtype
    transition = jax.jit(make_hmc_transition(logdensity_fn,
                                             num_integration_steps))
    q = init_positions
    da = da_init(init_step_size, dtype)
    wf = welford_init(P, dtype)
    wf = WelfordState(wf.count, wf.mean, wf.m2 + 1.0)
    keys = jax.random.split(key, num_warmup + num_samples)
    for i in range(num_warmup):
        eps = jnp.exp(da.log_eps)
        inv_mass = welford_variance(wf)
        q, ld, acc, _ = transition(q, keys[i], eps, inv_mass)
        da = da_update(da, jnp.mean(acc), target=target_accept)
        wf = welford_add_batch(wf, q)
    eps = jnp.exp(da.log_eps_avg)
    inv_mass = welford_variance(wf)
    samples, lds, accs, ndiv = [], [], [], 0
    for i in range(num_warmup, num_warmup + num_samples):
        q, ld, acc, div = transition(q, keys[i], eps, inv_mass)
        samples.append(np.asarray(q))
        lds.append(np.asarray(ld))
        accs.append(float(jnp.mean(acc)))
        ndiv += int(jnp.sum(div))
    return HMCResult(samples=jnp.asarray(np.stack(samples)),
                     logdensities=jnp.asarray(np.stack(lds)),
                     accept_rate=jnp.asarray(np.mean(accs)),
                     step_size=eps, inv_mass=inv_mass,
                     divergences=jnp.asarray(ndiv, jnp.int32))


def hmc_sample(logdensity_fn: Callable, init_positions: jax.Array,
               key: jax.Array, num_warmup: int = 500, num_samples: int = 500,
               num_integration_steps: int = 16, init_step_size: float = 0.01,
               target_accept: float = 0.8, adapted=None,
               warmup_state=None,
               shared_adaptation: bool = True) -> HMCResult:
    """Run C chains of HMC with shared warmup adaptation; fully jitted.

    ``init_positions``: (chains, P); ``logdensity_fn``: (P,) -> scalar.

    Bounded-execution continuation (``bayes/segmented.py``): pass
    ``adapted=(step_size, inv_mass)`` with ``num_warmup=0`` to skip
    adaptation and continue sampling exactly from ``init_positions`` (use a
    previous result's ``final_positions``); or ``warmup_state=(da, wf)``
    from a previous result to CONTINUE warmup adaptation across chunks
    (with ``num_samples=0`` for pure warmup chunks).  Chunked == one-shot
    in law — the kernel is Markov and the adaptation carry is exact; only
    the RNG key splits differ.

    ``shared_adaptation=False`` adapts a PER-CHAIN step size (dual
    averaging on each chain's own acceptance) and per-chain diagonal mass
    — the fleet mode for many random-init chains on multimodal
    posteriors, where basins have different curvature scales and one
    shared (eps, mass) collapses (measured: 64 random-init chains with
    shared adaptation froze at 0.008 acceptance / 11.6k divergences on
    the dim-1163 posterior, ``results/hmc/deep_ladder_campaign.json``;
    per-chain adaptation is the fix).  Chains stay one (C, P) batch;
    the continuation contract is unchanged (``step_size`` is then (C,),
    ``inv_mass`` (C, P)).
    """
    C, P = init_positions.shape
    vg = jax.vmap(jax.value_and_grad(logdensity_fn))

    def ld_grad(q):
        return vg(q)

    def kinetic(p, inv_mass):
        im = inv_mass if inv_mass.ndim == 2 else inv_mass[None, :]
        return 0.5 * jnp.sum(p * p * im, axis=1)

    def transition(q, key, eps, inv_mass):
        k1, k2 = jax.random.split(key)
        im = inv_mass if inv_mass.ndim == 2 else inv_mass[None, :]
        mass_sqrt = 1.0 / jnp.sqrt(im)
        p0 = jax.random.normal(k1, q.shape, q.dtype) * mass_sqrt
        ld0, g0 = ld_grad(q)
        h0 = -ld0 + kinetic(p0, inv_mass)
        q1, p1, ld1 = leapfrog(ld_grad, q, p0, eps, inv_mass,
                               num_integration_steps,
                               init_ld_grad=(ld0, g0))
        h1 = -ld1 + kinetic(p1, inv_mass)
        delta = h1 - h0
        div = jnp.logical_or(~jnp.isfinite(delta), delta > MAX_DELTA_ENERGY)
        log_accept = jnp.minimum(0.0, -delta)
        log_accept = jnp.where(jnp.isfinite(log_accept), log_accept, -jnp.inf)
        u = jax.random.uniform(k2, (C,))
        accept = jnp.log(u) < log_accept
        q_next = jnp.where(accept[:, None], q1, q)
        ld_next = jnp.where(accept, ld1, ld0)
        return q_next, ld_next, jnp.exp(log_accept), div

    # -- warmup: adapt eps (dual averaging) + mass (Welford) -----------------
    # shared mode: ONE (eps, mass) from the mean acceptance across chains
    # (the cross-chain collective); fleet mode: per-chain states, same ops
    # vmapped over the chain axis.
    da_up = (da_update if shared_adaptation
             else jax.vmap(lambda st, a: da_update(st, a,
                                                   target=target_accept)))
    wf_var = (welford_variance if shared_adaptation
              else jax.vmap(welford_variance))

    def warmup_step(carry, key):
        q, da, wf = carry
        eps = jnp.exp(da.log_eps)
        inv_mass = wf_var(wf)
        q, ld, acc, _ = transition(q, key, eps, inv_mass)
        if shared_adaptation:
            da = da_update(da, jnp.mean(acc), target=target_accept)
            wf = welford_add_batch(wf, q)
        else:
            da = da_up(da, acc)
            wf = jax.vmap(welford_add_batch)(wf, q[:, None, :])
        return (q, da, wf), None

    dtype = init_positions.dtype
    keys = jax.random.split(key, num_warmup + num_samples + 1)
    out_warmup_state = None
    if adapted is not None:
        q = init_positions
        eps = jnp.asarray(adapted[0], dtype)
        inv_mass = jnp.asarray(adapted[1], dtype)
    else:
        if warmup_state is not None:
            da0, wf0 = warmup_state
        else:
            da0 = da_init(init_step_size, dtype)
            wf0 = welford_init(P, dtype)
            # Seed the mass estimate at unit variance until draws accumulate.
            wf0 = WelfordState(wf0.count, wf0.mean, wf0.m2 + 1.0)
            if not shared_adaptation:
                da0 = jax.tree.map(
                    lambda x: jnp.broadcast_to(x, (C,) + x.shape), da0)
                wf0 = jax.tree.map(
                    lambda x: jnp.broadcast_to(x, (C,) + x.shape), wf0)
        (q, da, wf), _ = jax.lax.scan(
            warmup_step, (init_positions, da0, wf0), keys[:num_warmup])
        out_warmup_state = (da, wf)
        eps = jnp.exp(da.log_eps_avg)
        inv_mass = wf_var(wf)

    # -- sampling ------------------------------------------------------------
    def sample_step(q, key):
        q, ld, acc, div = transition(q, key, eps, inv_mass)
        return q, (q, ld, jnp.mean(acc), jnp.sum(div.astype(jnp.int32)))

    q, (samples, lds, accs, divs) = jax.lax.scan(
        sample_step, q, keys[num_warmup:num_warmup + num_samples])
    return HMCResult(samples=samples, logdensities=lds,
                     accept_rate=jnp.mean(accs), step_size=eps,
                     inv_mass=inv_mass, divergences=jnp.sum(divs),
                     final_positions=q, warmup_state=out_warmup_state)
