"""Parallel-tempered chain-parallel HMC for multimodal SCFGP posteriors.

SURVEY.md §7.2 flags the frequency-matrix posterior as non-log-concave
(trig multimodality) and calls for "tempering/multi-start" beyond plain
HMC.  Multi-start is the per-chain random init; this module adds replica
exchange (parallel tempering):

  * T temperature rungs x C chains evolve as ONE (T, C, P) position tensor
    — every leapfrog step batches T*C NLML gradient evaluations through the
    same GEMMs, the same chain-parallel design as ``hmc.hmc_sample`` (and
    the rung/chain axes can be sharded over devices like the chain axis);
  * rung t targets ``beta_t * logpost`` (betas[0] must be 1.0 — the cold
    rung is the posterior); hotter rungs flatten the trig modes so replicas
    cross between basins;
  * per-rung dual-averaging step sizes (hot rungs take larger steps) and
    per-rung diagonal Welford mass estimates, adapted during warmup;
  * after every transition, adjacent rungs propose swaps in the standard
    even/odd alternating-parity schedule: pair (t, t+1) swaps with
    probability ``min(1, exp((beta_t - beta_{t+1}) (E_{t+1} - E_t)))`` where
    ``E`` is the UNtempered log posterior — detailed balance per rung pair;
  * the returned samples are the cold rung's draws.

Fully fused: one jit, two ``lax.scan``s (warmup, sampling) — the same
program shape as ``hmc_sample``.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .hmc import (MAX_DELTA_ENERGY, DualAveragingState, WelfordState,
                  da_init, da_update, welford_add_batch, welford_variance)


class TemperedHMCResult(NamedTuple):
    samples: jax.Array       # (num_samples, C, P) — cold-rung draws
    logdensities: jax.Array  # (num_samples, C) — untempered logpost
    accept_rate: jax.Array   # () mean HMC acceptance over rungs/chains
    swap_rate: jax.Array     # () mean swap acceptance over proposed pairs
    step_sizes: jax.Array    # (T,) adapted per-rung step sizes
    inv_mass: jax.Array      # (T, P) per-rung diagonal inverse mass
    # () cold-rung divergent transitions during sampling (see
    # hmc.MAX_DELTA_ENERGY).  None default — a jnp literal here would touch
    # the XLA backend at import time (see hmc.HMCResult).
    divergences: jax.Array = None
    # (T, C, P) final positions of ALL rungs — the resume state for
    # segmented runs (tempered_hmc_sample_segmented).
    final_positions: jax.Array = None
    # ((T,)-shaped DualAveragingState, (T,P) WelfordState) adaptation carry
    # after this call's warmup steps — pass back via ``warmup_state=`` to
    # continue warmup across bounded executions (None if warmup skipped).
    warmup_state: tuple = None


def geometric_ladder(n_rungs: int, beta_min: float = 0.1,
                     dtype=jnp.float32) -> jax.Array:
    """Geometric temperature ladder from 1.0 down to ``beta_min``.

    Ladder-spacing guidance: a swap between adjacent rungs accepts with
    probability ~exp(-dbeta * dE), so rungs must satisfy
    ``dbeta ≲ 1 / std(E)`` to mix.  For an N-row SCFGP posterior
    ``std(logpost)`` grows like sqrt(N) — at N=2048 the default 4-rung
    ladder measures swap_rate = 0 (docs/RESULTS.md) and needs
    ``energy_matched_ladder`` (below), which measures std(E) and spaces
    rungs to a target exponent.
    Monitor ``TemperedHMCResult.swap_rate`` (healthy: 0.2-0.6); the
    low-dimensional multimodal regime (the bimodal escape test) works with
    short ladders."""
    return jnp.asarray(
        jnp.geomspace(1.0, beta_min, n_rungs), dtype)


def energy_matched_ladder(logdensity_fn: Callable, positions: jax.Array,
                          beta_min: float = 0.1, target_gap: float = 1.0,
                          max_rungs: int = 64) -> jax.Array:
    """Ladder spaced by the MEASURED energy scale so swaps actually accept.

    Swap acceptance between adjacent rungs is ~exp(-dbeta * dE); with
    ``std_E`` the WITHIN-CHAIN energy fluctuation, spacing
    ``dbeta = target_gap / std_E`` puts the expected exponent near
    ``target_gap`` — the linear analog of the Kone-Kofke constant-
    acceptance prescription.  Returns a LINEAR ladder
    ``1, 1-d, 1-2d, ..., >= beta_min`` capped at ``max_rungs`` (rungs are
    cheap: every rung batches through the same GEMMs).

    ``positions``: (num, P) pooled draws, or — better — (T, C, P) warmup
    draws per chain: with trig-multimodal posteriors the chains settle in
    basins whose energies differ by O(100), so the POOLED std wildly
    overestimates the fluctuation scale that actually governs adjacent-rung
    swaps; the (T, C, P) form uses the median per-chain std instead.

    Host-side helper (concrete float ladder; call outside jit).
    """
    import numpy as np
    if positions.ndim == 3:
        T_, C_, P_ = positions.shape
        lds = np.asarray(jax.vmap(logdensity_fn)(
            positions.reshape(T_ * C_, P_)), np.float64).reshape(T_, C_)
        std_e = float(np.median(np.std(lds, axis=0)))
    else:
        lds = np.asarray(jax.vmap(logdensity_fn)(positions), np.float64)
        std_e = float(np.std(lds))
    if not np.isfinite(std_e) or std_e < 1e-12:
        return geometric_ladder(4, beta_min, positions.dtype)
    d = max(target_gap / std_e, (1.0 - beta_min) / (max_rungs - 1))
    n = int(np.floor((1.0 - beta_min) / d)) + 1
    betas = 1.0 - d * np.arange(n)
    if betas[-1] > beta_min + 1e-9:
        betas = np.append(betas, beta_min)
    return jnp.asarray(betas, positions.dtype)


def tempered_hmc_sample(logdensity_fn: Callable, init_positions: jax.Array,
                        key: jax.Array, betas=None,
                        num_warmup: int = 500, num_samples: int = 500,
                        num_integration_steps: int = 16,
                        init_step_size: float = 0.01,
                        target_accept: float = 0.8,
                        init_all_rungs=None,
                        adapted=None, step_offset=0,
                        warmup_state=None) -> TemperedHMCResult:
    """Replica-exchange HMC.  ``init_positions``: (C, P) cold-rung inits
    (replicated across rungs); ``logdensity_fn``: (P,) -> scalar.

    Continuation (for segmented runs): pass ``init_all_rungs`` (T, C, P)
    from a previous result's ``final_positions`` and ``adapted =
    (step_sizes, inv_mass)`` with ``num_warmup=0`` — adaptation is then
    skipped and sampling continues the chain exactly.  ``step_offset``
    (int scalar, traceable) shifts the global step index so the
    deterministic even/odd swap-parity (DEO) alternation continues across
    segment boundaries instead of restarting at even parity each segment
    (ADVICE r3)."""
    C, P = init_positions.shape
    dtype = init_positions.dtype
    if betas is None:
        # The fixed geometric_ladder(4) default measured swap_rate = 0 on a
        # data-sized posterior (docs/RESULTS.md): dbeta ~ 0.3 vs the required
        # ~1/std(E).  Auto-match the ladder to the measured energy scale when
        # the inits are concrete; inside a jit trace that is impossible, so
        # warn loudly and fall back.
        import warnings
        try:
            betas = energy_matched_ladder(logdensity_fn, init_positions)
        except Exception:
            warnings.warn(
                "tempered_hmc_sample: betas=None under tracing falls back to"
                " geometric_ladder(4), which does NOT mix on data-sized"
                " posteriors (swap_rate=0 measured). Build an"
                " energy_matched_ladder from warmed-up positions outside jit"
                " and pass it explicitly.", stacklevel=2)
            betas = geometric_ladder(4, dtype=dtype)
    betas = jnp.asarray(betas, dtype)
    T = betas.shape[0]
    # cold rung first: the output draws are q[0]
    # (a traced betas[0] can't be asserted here; geometric_ladder guarantees
    # it, and custom ladders must follow the same convention)

    base_vg = jax.vmap(jax.vmap(jax.value_and_grad(logdensity_fn)))

    def kinetic(p, inv_mass):
        return 0.5 * jnp.sum(p * p * inv_mass[:, None, :], axis=-1)  # (T, C)

    def transition(q, key, eps, inv_mass):
        """One tempered HMC step on the whole (T, C, P) tensor.

        ``eps``: (T,), ``inv_mass``: (T, P).  Returns (q, untempered ld,
        accept probs (T, C))."""
        k1, k2 = jax.random.split(key)
        mass_sqrt = 1.0 / jnp.sqrt(inv_mass)                     # (T, P)
        p0 = jax.random.normal(k1, q.shape, dtype) * mass_sqrt[:, None, :]
        ld0, g0 = base_vg(q)                                     # (T, C)
        h0 = -betas[:, None] * ld0 + kinetic(p0, inv_mass)
        e = eps[:, None, None]

        # Gradient-cached leapfrog (see hmc.leapfrog): the second
        # half-kick's gradient doubles as the next step's first — L+1
        # untempered gradient batches per trajectory instead of 2L+2.
        def leap(carry, _):
            qq, pp, g = carry
            pp = pp + 0.5 * e * betas[:, None, None] * g
            qq = qq + e * inv_mass[:, None, :] * pp
            ld, g = base_vg(qq)
            pp = pp + 0.5 * e * betas[:, None, None] * g
            return (qq, pp, g), ld

        (q1, p1, _), lds = jax.lax.scan(leap, (q, p0, g0), None,
                                        length=num_integration_steps)
        ld1 = lds[-1]
        h1 = -betas[:, None] * ld1 + kinetic(p1, inv_mass)
        delta = h1 - h0
        div = jnp.logical_or(~jnp.isfinite(delta), delta > MAX_DELTA_ENERGY)
        log_accept = jnp.minimum(0.0, -delta)
        log_accept = jnp.where(jnp.isfinite(log_accept), log_accept,
                               -jnp.inf)
        u = jax.random.uniform(k2, (T, C))
        accept = jnp.log(u) < log_accept
        q_next = jnp.where(accept[..., None], q1, q)
        ld_next = jnp.where(accept, ld1, ld0)
        return q_next, ld_next, jnp.exp(log_accept), div

    pair_t = jnp.arange(T - 1)

    def swap(q, ld, key, parity):
        """Even/odd alternating adjacent-rung exchange (detailed balance)."""
        delta = (betas[:-1] - betas[1:])[:, None] * (ld[1:] - ld[:-1])
        u = jax.random.uniform(key, (T - 1, C))
        valid = (pair_t % 2 == parity)[:, None]                  # (T-1, 1)
        acc = (jnp.log(u) < delta) & valid                       # (T-1, C)
        take_next = jnp.concatenate(
            [acc, jnp.zeros((1, C), bool)], axis=0)              # (T, C)
        take_prev = jnp.concatenate(
            [jnp.zeros((1, C), bool), acc], axis=0)
        q_sw = jnp.where(take_next[..., None], jnp.roll(q, -1, axis=0), q)
        q_sw = jnp.where(take_prev[..., None], jnp.roll(q, 1, axis=0), q_sw)
        ld_sw = jnp.where(take_next, jnp.roll(ld, -1, axis=0), ld)
        ld_sw = jnp.where(take_prev, jnp.roll(ld, 1, axis=0), ld_sw)
        n_valid = jnp.sum(valid) * C
        rate = jnp.sum(acc) / jnp.maximum(n_valid, 1)
        return q_sw, ld_sw, rate

    da_update_v = jax.vmap(
        functools.partial(da_update, target=target_accept))
    welford_add_v = jax.vmap(welford_add_batch)

    if init_all_rungs is not None:
        q0 = jnp.asarray(init_all_rungs, dtype)
    else:
        q0 = jnp.broadcast_to(init_positions[None], (T, C, P)).astype(dtype)
    da0 = jax.tree.map(lambda x: jnp.broadcast_to(x, (T,) + x.shape),
                       da_init(init_step_size, dtype))
    wf0 = WelfordState(jnp.zeros((T,), dtype),
                       jnp.zeros((T, P), dtype),
                       jnp.ones((T, P), dtype))  # unit-variance seed

    def warmup_step(carry, inp):
        q, da, wf = carry
        key, i = inp
        k_hmc, k_swap = jax.random.split(key)
        eps = jnp.exp(da.log_eps)                                # (T,)
        inv_mass = jax.vmap(welford_variance)(wf)                # (T, P)
        q, ld, acc, _ = transition(q, k_hmc, eps, inv_mass)
        q, ld, _ = swap(q, ld, k_swap, i % 2)
        da = da_update_v(da, jnp.mean(acc, axis=1))
        wf = welford_add_v(wf, q)
        return (q, da, wf), None

    n_total = num_warmup + num_samples
    keys = jax.random.split(key, n_total)
    steps = jnp.arange(n_total) + jnp.asarray(step_offset, jnp.int32)
    out_warmup_state = None
    if adapted is not None:
        q = q0
        eps = jnp.asarray(adapted[0], dtype)
        inv_mass = jnp.asarray(adapted[1], dtype)
    else:
        if warmup_state is not None:
            da0, wf0 = warmup_state
        (q, da, wf), _ = jax.lax.scan(
            warmup_step, (q0, da0, wf0),
            (keys[:num_warmup], steps[:num_warmup]))
        out_warmup_state = (da, wf)
        eps = jnp.exp(da.log_eps_avg)
        inv_mass = jax.vmap(welford_variance)(wf)

    def sample_step(q_ld, inp):
        q, ld = q_ld
        key, i = inp
        k_hmc, k_swap = jax.random.split(key)
        q, ld, acc, div = transition(q, k_hmc, eps, inv_mass)
        q, ld, srate = swap(q, ld, k_swap, i % 2)
        return (q, ld), (q[0], ld[0], jnp.mean(acc), srate,
                         jnp.sum(div[0].astype(jnp.int32)))

    ld_init, _ = base_vg(q)
    (q, _), (samples, lds, accs, srates, divs) = jax.lax.scan(
        sample_step, (q, ld_init),
        (keys[num_warmup:], steps[num_warmup:]))
    return TemperedHMCResult(
        samples=samples, logdensities=lds,
        accept_rate=jnp.mean(accs), swap_rate=jnp.mean(srates),
        step_sizes=eps, inv_mass=inv_mass, divergences=jnp.sum(divs),
        final_positions=q, warmup_state=out_warmup_state)


def tempered_hmc_sample_segmented(logdensity_fn: Callable,
                                  init_positions: jax.Array,
                                  key: jax.Array, betas,
                                  num_warmup: int = 100,
                                  num_samples: int = 400,
                                  segment: int = 100,
                                  num_integration_steps: int = 16,
                                  init_step_size: float = 0.01,
                                  target_accept: float = 0.8,
                                  init_all_rungs=None,
                                  adapted=None, step_offset: int = 0,
                                  jit: bool = True) -> TemperedHMCResult:
    """Long tempered runs as a host loop of bounded XLA executions.

    The user option ``SCFGP.fit_bayes(segment=k)`` for bounded device
    executions: CHUNKED WARMUP (the per-rung dual-averaging + Welford
    adaptation carry threads across bounded executions via
    ``warmup_state``), then sampling segments from ``final_positions``
    with adaptation frozen.  Three
    compiled programs total (warmup chunk, odd warmup tail, sampling
    segment), any number of chunks; the concatenated chain is a valid
    continuation of the same chain — the kernel is Markov, every piece
    of adaptation state is carried exactly, and the global step index
    (hence the DEO swap parity) is threaded across boundaries via
    ``step_offset`` — the only difference in law from one long scan is
    where the RNG keys split.

    Continuation (persisted-adaptation reuse, ``SCFGP.fit_bayes``): pass
    ``init_all_rungs`` (T, C, P), ``adapted=(step_sizes, inv_mass)`` and
    the prior run's total ``step_offset`` — the warmup stage is skipped
    entirely and sampling segments continue the chain exactly (same
    contract as ``tempered_hmc_sample``'s own continuation args)."""
    import numpy as np

    n_seg = -(-num_samples // segment)
    # betas ride as TRACED arguments: ladders differ per dataset/seed in
    # VALUES far more often than in length, and closing them over would
    # recompile the segment programs for every new ladder.
    betas = jnp.asarray(betas)
    wrap = jax.jit if jit else (lambda f: f)

    # -- warmup in bounded chunks -------------------------------------------
    warm_sizes = [segment] * (num_warmup // segment)
    if num_warmup % segment:
        warm_sizes.append(num_warmup % segment)
    warm_progs = {}

    def warm_chunk(qa, k, b, st, off, n):
        prog = warm_progs.get((n, st is None))
        if prog is None:
            prog = wrap(lambda qa_, k_, b_, st_, off_: tempered_hmc_sample(
                logdensity_fn, init_positions, k_, betas=b_, num_warmup=n,
                num_samples=0,
                num_integration_steps=num_integration_steps,
                init_step_size=init_step_size,
                target_accept=target_accept, init_all_rungs=qa_,
                warmup_state=st_, step_offset=off_))
            warm_progs[(n, st is None)] = prog
        return prog(qa, k, b, st, off)

    if adapted is not None:
        # Continuation: skip warmup entirely — positions + per-rung
        # (eps, mass) come from a previous run's result/cache.
        q_all = jnp.asarray(init_all_rungs)
        eps, im = adapted
        off = int(step_offset)
    else:
        q_all = init_all_rungs
        state = None
        off = int(step_offset)
        rw = None
        for i, n in enumerate(warm_sizes):
            rw = warm_chunk(q_all, jax.random.fold_in(key, 1000 + i), betas,
                            state, jnp.asarray(off, jnp.int32), n)
            q_all = rw.final_positions
            state = rw.warmup_state
            np.asarray(q_all)  # host readback bounds the execution
            off += n
        if rw is not None:
            eps, im = rw.step_sizes, rw.inv_mass
        else:  # num_warmup == 0: init_step_size + unit mass, like one-shot
            rw = warm_chunk(None, jax.random.fold_in(key, 999), betas, None,
                            jnp.asarray(0, jnp.int32), 0)
            q_all = rw.final_positions
            eps, im = rw.step_sizes, rw.inv_mass

    # -- sampling segments with adaptation frozen ---------------------------
    cont = wrap(
        lambda qa, k, b, eps_, im_, off_: tempered_hmc_sample(
            logdensity_fn, init_positions, k, betas=b,
            num_warmup=0, num_samples=segment,
            num_integration_steps=num_integration_steps,
            init_step_size=init_step_size, target_accept=target_accept,
            init_all_rungs=qa, adapted=(eps_, im_), step_offset=off_))
    samples, lds, accs, srates, divs = [], [], [], [], []
    for s_i in range(n_seg):
        r = cont(q_all, jax.random.fold_in(key, s_i), betas, eps, im,
                 jnp.asarray(off + s_i * segment, jnp.int32))
        samples.append(np.asarray(r.samples))   # readback bounds execution
        lds.append(np.asarray(r.logdensities))
        accs.append(float(r.accept_rate))
        srates.append(float(r.swap_rate))
        divs.append(int(r.divergences))
        q_all = r.final_positions
    return TemperedHMCResult(
        samples=jnp.asarray(np.concatenate(samples)[:num_samples]),
        logdensities=jnp.asarray(np.concatenate(lds)[:num_samples]),
        accept_rate=jnp.asarray(np.mean(accs)),
        swap_rate=jnp.asarray(np.mean(srates)),
        step_sizes=eps, inv_mass=im,
        divergences=jnp.asarray(sum(divs)), final_positions=q_all)
