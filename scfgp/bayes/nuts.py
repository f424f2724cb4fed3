"""No-U-Turn Sampler (iterative, multinomial), chain-parallel on device.

Implements NUTS with multinomial progressive sampling and the generalized
U-turn criterion, in the *iterative* formulation (Phan & Hoffman's
iterative-NUTS scheme): subtrees are built leaf by leaf with a
checkpoint stack of size ``max_depth`` for the O(log L) internal U-turn
checks, so the whole transition is ``lax.while_loop``/``fori_loop`` control
flow — jittable, ``vmap``-able over chains (per-chain dynamic trajectory
lengths become masked lanes), and shardable over a chain mesh axis.

Checkpoint-stack discipline (derived in-code): processing leaves
``n = 0..2^j-1`` of a subtree, an even ``n`` pushes one checkpoint
``(r_n, csum_{n-1})``; an odd ``n`` with ``t`` trailing one-bits closes ``t``
binary blocks whose start checkpoints are exactly the top ``t`` stack
entries (checked innermost-out), after which ``t - 1`` entries are dead and
popped.  Block ``[s, n]`` turns when ``dot(csum_n - csum_{s-1}, v)`` is
non-positive for the velocity ``v = inv_mass * r`` at either block end.

Step-size warmup shares the HMC dual-averaging machinery, driven by the mean
acceptance statistic across all chains (a cross-chip collective when the
chain axis is sharded); the diagonal mass matrix is Welford-estimated from
all chains' warmup draws.

New capability beyond the MAP-only reference (SURVEY.md §2.4).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .hmc import (DualAveragingState, da_init, da_update, welford_init,
                  welford_add_batch, welford_variance, WelfordState,
                  HMCResult)

MAX_DELTA_ENERGY = 1000.0


class _TreeState(NamedTuple):
    z_minus: jax.Array
    r_minus: jax.Array
    g_minus: jax.Array      # cached gradient at z_minus (see hmc.leapfrog)
    z_plus: jax.Array
    r_plus: jax.Array
    g_plus: jax.Array       # cached gradient at z_plus
    z_prop: jax.Array       # current multinomial proposal
    ld_prop: jax.Array      # its log density
    log_weight: jax.Array   # logsumexp of leaf weights in the trajectory
    sum_r: jax.Array        # total momentum sum over trajectory
    sum_accept: jax.Array   # sum of per-leaf accept probs (for adaptation)
    num_leaves: jax.Array
    depth: jax.Array
    turning: jax.Array
    diverging: jax.Array


def _leapfrog_1_cached(ld_grad, z, r, g, eps_signed, inv_mass):
    """One leapfrog step reusing the cached gradient at z (the previous
    step's endpoint gradient — see ``hmc.leapfrog``): ONE new gradient per
    leaf instead of two.  Returns the new ``(z, r, ld, g)``."""
    r = r + 0.5 * eps_signed * g
    z = z + eps_signed * inv_mass * r
    ld, g = ld_grad(z)
    r = r + 0.5 * eps_signed * g
    return z, r, ld, g


def _is_turning(sum_r, r_a, r_b, inv_mass):
    return jnp.logical_or(
        jnp.sum(sum_r * inv_mass * r_a) <= 0.0,
        jnp.sum(sum_r * inv_mass * r_b) <= 0.0)


def _count_trailing_ones(n):
    """Number of trailing 1-bits of int32 n (vector-friendly)."""
    # n ^ (n+1) has bits 0..t set, where t = trailing ones count.
    x = jnp.bitwise_xor(n, n + 1)  # == 2^(t+1) - 1
    # popcount via bit tricks on int32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) - 1  # popcount(2^(t+1)-1) = t+1


def _build_subtree(ld_grad, edge_z, edge_r, edge_g, depth, eps_signed,
                   inv_mass, h0, key, max_depth):
    """Iteratively build a 2^depth-leaf subtree from (edge_z, edge_r).

    ``edge_g`` is the cached gradient at edge_z (one new gradient per
    leaf — see hmc.leapfrog).  Returns (ok, z_end, r_end, g_end, z_prop,
    ld_prop, log_weight, sum_r, sum_accept, num_leaves, diverged).
    ``ok`` is False on internal U-turn/divergence.
    """
    P = edge_z.shape[0]
    num_leaves = jnp.int32(1) << depth

    # Checkpoint stacks (static size = max_depth + 1).
    r_ck = jnp.zeros((max_depth + 1, P), edge_r.dtype)
    csum_ck = jnp.zeros((max_depth + 1, P), edge_r.dtype)

    dt = edge_z.dtype
    init = dict(
        n=jnp.int32(0), sp=jnp.int32(0),
        z=edge_z, r=edge_r, g=edge_g, ld=jnp.zeros((), dt),
        csum=jnp.zeros(P, edge_r.dtype),
        z_prop=edge_z, ld_prop=jnp.asarray(-jnp.inf, dt),
        log_w=jnp.asarray(-jnp.inf, dt),
        sum_acc=jnp.zeros((), dt), r_ck=r_ck, csum_ck=csum_ck,
        bad=jnp.bool_(False), div=jnp.bool_(False), key=key,
    )

    def cond(s):
        return jnp.logical_and(s["n"] < num_leaves,
                               jnp.logical_not(s["bad"]))

    def body(s):
        z, r, ld, g = _leapfrog_1_cached(ld_grad, s["z"], s["r"], s["g"],
                                         eps_signed, inv_mass)
        energy = -ld + 0.5 * jnp.sum(r * r * inv_mass)
        delta = energy - h0  # h0 = energy at trajectory start
        diverging = jnp.logical_or(~jnp.isfinite(delta),
                                   delta > MAX_DELTA_ENERGY)
        log_w_leaf = jnp.where(diverging, -jnp.inf, -delta).astype(s["log_w"].dtype)
        accept = jnp.where(diverging, 0.0,
                           jnp.minimum(1.0, jnp.exp(-delta))).astype(s["sum_acc"].dtype)

        # Progressive multinomial proposal within the subtree.
        key, ku = jax.random.split(s["key"])
        log_w_new = jnp.logaddexp(s["log_w"], log_w_leaf)
        take = jnp.log(jax.random.uniform(ku)) < (log_w_leaf - log_w_new)
        z_prop = jnp.where(take, z, s["z_prop"])
        ld_prop = jnp.where(take, ld, s["ld_prop"])

        n = s["n"]
        csum = s["csum"] + r

        # Push checkpoint (r_n, csum_before) at even leaf indices.
        even = (n % 2) == 0
        sp = s["sp"]
        r_ck = jnp.where(even, s["r_ck"].at[sp].set(r), s["r_ck"])
        csum_ck = jnp.where(even, s["csum_ck"].at[sp].set(s["csum"]),
                            s["csum_ck"])
        sp = jnp.where(even, sp + 1, sp)

        # At odd n: check the top t completed blocks, then pop t-1.
        t = jnp.where(even, 0, _count_trailing_ones(n))

        def check_block(i, turning):
            idx = sp - 1 - i
            valid = i < t
            blk_sum = csum - csum_ck[idx]
            turn = _is_turning(blk_sum, r_ck[idx], r, inv_mass)
            return jnp.logical_or(turning, jnp.logical_and(valid, turn))

        turning = jax.lax.fori_loop(0, max_depth + 1, check_block,
                                    jnp.bool_(False))
        sp = jnp.where(t > 0, sp - (t - 1), sp)

        bad = jnp.logical_or(diverging, turning)
        return dict(n=n + 1, sp=sp, z=z, r=r, g=g, ld=ld, csum=csum,
                    z_prop=z_prop, ld_prop=ld_prop, log_w=log_w_new,
                    sum_acc=s["sum_acc"] + accept, r_ck=r_ck,
                    csum_ck=csum_ck, bad=bad,
                    div=jnp.logical_or(s["div"], diverging), key=key)

    out = jax.lax.while_loop(cond, body, init)
    ok = jnp.logical_not(out["bad"])
    return (ok, out["z"], out["r"], out["g"], out["z_prop"],
            out["ld_prop"], out["log_w"], out["csum"], out["sum_acc"],
            jnp.asarray(num_leaves, edge_z.dtype), out["div"])


def _nuts_transition(ld_grad, z0, key, eps, inv_mass, max_depth):
    """One NUTS transition for a single chain; vmap over chains outside."""
    P = z0.shape[0]
    k_mom, k_loop = jax.random.split(key)
    mass_sqrt = 1.0 / jnp.sqrt(inv_mass)
    r0 = jax.random.normal(k_mom, (P,), z0.dtype) * mass_sqrt
    ld0, g0 = ld_grad(z0)
    h0 = -ld0 + 0.5 * jnp.sum(r0 * r0 * inv_mass)

    dt = z0.dtype
    tree = _TreeState(
        z_minus=z0, r_minus=r0, g_minus=g0, z_plus=z0, r_plus=r0,
        g_plus=g0,
        z_prop=z0, ld_prop=ld0.astype(dt), log_weight=jnp.zeros((), dt),
        sum_r=r0, sum_accept=jnp.zeros((), dt), num_leaves=jnp.ones((), dt),
        depth=jnp.int32(0), turning=jnp.bool_(False),
        diverging=jnp.bool_(False))

    def cond(carry):
        tree, _ = carry
        return jnp.logical_and(
            tree.depth < max_depth,
            jnp.logical_not(jnp.logical_or(tree.turning, tree.diverging)))

    def body(carry):
        tree, key = carry
        key, k_dir, k_sub, k_merge = jax.random.split(key, 4)
        go_right = jax.random.bernoulli(k_dir)
        eps_signed = jnp.where(go_right, eps, -eps)
        edge_z = jnp.where(go_right, tree.z_plus, tree.z_minus)
        edge_r = jnp.where(go_right, tree.r_plus, tree.r_minus)
        edge_g = jnp.where(go_right, tree.g_plus, tree.g_minus)

        (ok, z_end, r_end, g_end, z_prop_s, ld_prop_s, log_w_s, sum_r_s,
         sum_acc_s, leaves_s, div_s) = _build_subtree(
            ld_grad, edge_z, edge_r, edge_g, tree.depth, eps_signed,
            inv_mass, h0, k_sub, max_depth)

        # Merge only when the subtree is valid (multinomial NUTS: a broken
        # doubling is discarded wholesale and the trajectory ends).
        z_plus = jnp.where(go_right & ok, z_end, tree.z_plus)
        r_plus = jnp.where(go_right & ok, r_end, tree.r_plus)
        g_plus = jnp.where(go_right & ok, g_end, tree.g_plus)
        z_minus = jnp.where((~go_right) & ok, z_end, tree.z_minus)
        r_minus = jnp.where((~go_right) & ok, r_end, tree.r_minus)
        g_minus = jnp.where((~go_right) & ok, g_end, tree.g_minus)

        # Biased progressive sampling between old trajectory and subtree.
        take = jnp.log(jax.random.uniform(k_merge)) < (
            log_w_s - tree.log_weight)
        take = jnp.logical_and(take, ok)
        z_prop = jnp.where(take, z_prop_s, tree.z_prop)
        ld_prop = jnp.where(take, ld_prop_s, tree.ld_prop).astype(tree.ld_prop.dtype)
        log_weight = jnp.where(ok, jnp.logaddexp(tree.log_weight, log_w_s),
                               tree.log_weight)
        sum_r = jnp.where(ok, tree.sum_r + sum_r_s, tree.sum_r)

        turning_total = jnp.where(
            ok, _is_turning(sum_r, r_minus, r_plus, inv_mass), tree.turning)

        new_tree = _TreeState(
            z_minus=z_minus, r_minus=r_minus, g_minus=g_minus,
            z_plus=z_plus, r_plus=r_plus, g_plus=g_plus,
            z_prop=z_prop, ld_prop=ld_prop, log_weight=log_weight,
            sum_r=sum_r,
            sum_accept=tree.sum_accept + sum_acc_s.astype(tree.sum_accept.dtype),
            num_leaves=tree.num_leaves + leaves_s.astype(tree.num_leaves.dtype),
            depth=tree.depth + 1,
            turning=jnp.logical_or(turning_total, ~ok),
            diverging=jnp.logical_or(tree.diverging, div_s))
        return new_tree, key

    tree, _ = jax.lax.while_loop(cond, body, (tree, k_loop))
    accept_stat = tree.sum_accept / jnp.maximum(tree.num_leaves - 1.0, 1.0)
    return tree.z_prop, tree.ld_prop, accept_stat, tree.depth, tree.diverging


class NUTSResult(NamedTuple):
    samples: jax.Array       # (num_samples, chains, P)
    logdensities: jax.Array  # (num_samples, chains)
    accept_rate: jax.Array
    step_size: jax.Array
    inv_mass: jax.Array
    mean_depth: jax.Array
    # () divergent transitions during sampling (energy error >
    # MAX_DELTA_ENERGY).  None default — a jnp literal here would touch the
    # XLA backend at import time (see hmc.HMCResult).
    divergences: jax.Array = None
    # (chains, P) final positions + (da, wf) adaptation carry — segmented-
    # execution resume points, same contract as hmc.HMCResult.
    final_positions: jax.Array = None
    warmup_state: tuple = None


def nuts_sample(logdensity_fn: Callable, init_positions: jax.Array,
                key: jax.Array, num_warmup: int = 500,
                num_samples: int = 500, max_depth: int = 8,
                init_step_size: float = 0.01,
                target_accept: float = 0.8, adapted=None,
                warmup_state=None) -> NUTSResult:
    """Run C chains of NUTS with shared cross-chain warmup adaptation.

    ``adapted=(step_size, inv_mass)`` / ``warmup_state=(da, wf)``: the
    bounded-execution continuation contract shared by every sampler in the
    family (``hmc.hmc_sample`` docstring) — ``nuts_sample_segmented``
    (bayes/segmented.py) uses it to run long DYNAMIC-NUTS budgets as a
    host loop of bounded XLA executions."""
    C, P = init_positions.shape
    vg = jax.value_and_grad(logdensity_fn)

    def transition_all(q, key, eps, inv_mass):
        keys = jax.random.split(key, C)
        return jax.vmap(
            lambda z, k: _nuts_transition(vg, z, k, eps, inv_mass, max_depth)
        )(q, keys)

    def warmup_step(carry, key):
        q, da, wf = carry
        eps = jnp.exp(da.log_eps)
        inv_mass = welford_variance(wf)
        q, ld, acc, depth, _ = transition_all(q, key, eps, inv_mass)
        da = da_update(da, jnp.mean(acc), target=target_accept)
        wf = welford_add_batch(wf, q)
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
            wf0 = WelfordState(wf0.count, wf0.mean, wf0.m2 + 1.0)
        (q, da, wf), _ = jax.lax.scan(
            warmup_step, (init_positions, da0, wf0), keys[:num_warmup])
        out_warmup_state = (da, wf)
        eps = jnp.exp(da.log_eps_avg)
        inv_mass = welford_variance(wf)

    def sample_step(q, key):
        q, ld, acc, depth, div = transition_all(q, key, eps, inv_mass)
        return q, (q, ld, jnp.mean(acc), jnp.mean(depth.astype(jnp.float32)),
                   jnp.sum(div.astype(jnp.int32)))

    q, (samples, lds, accs, depths, divs) = jax.lax.scan(
        sample_step, q, keys[num_warmup:num_warmup + num_samples])
    return NUTSResult(samples=samples, logdensities=lds,
                      accept_rate=jnp.mean(accs), step_size=eps,
                      inv_mass=inv_mass, mean_depth=jnp.mean(depths),
                      divergences=jnp.sum(divs),
                      final_positions=q, warmup_state=out_warmup_state)


def nuts_sample_host_looped(logdensity_fn: Callable,
                            init_positions: jax.Array, key: jax.Array,
                            num_warmup: int = 500, num_samples: int = 500,
                            max_depth: int = 8,
                            init_step_size: float = 0.01,
                            target_accept: float = 0.8) -> NUTSResult:
    """Iterative NUTS with the per-step transition jitted but the adaptation
    loop on host (mirrors ``hmc_sample_host_looped``): the compiled program
    is ONE vmapped transition instead of a scan over the whole run — a
    small compiled program when compiling the fused run is too slow."""
    import numpy as np

    C, P = init_positions.shape
    dtype = init_positions.dtype
    vg = jax.value_and_grad(logdensity_fn)

    @jax.jit
    def transition_all(q, key, eps, inv_mass):
        keys = jax.random.split(key, C)
        return jax.vmap(
            lambda z, k: _nuts_transition(vg, z, k, eps, inv_mass, max_depth)
        )(q, keys)

    q = init_positions
    da = da_init(init_step_size, dtype)
    wf = welford_init(P, dtype)
    wf = WelfordState(wf.count, wf.mean, wf.m2 + 1.0)
    keys = jax.random.split(key, num_warmup + num_samples)
    for i in range(num_warmup):
        eps = jnp.exp(da.log_eps)
        inv_mass = welford_variance(wf)
        q, ld, acc, depth, _ = transition_all(q, keys[i], eps, inv_mass)
        da = da_update(da, jnp.mean(acc), target=target_accept)
        wf = welford_add_batch(wf, q)
    eps = jnp.exp(da.log_eps_avg)
    inv_mass = welford_variance(wf)
    samples, lds, accs, depths, ndiv = [], [], [], [], 0
    for i in range(num_warmup, num_warmup + num_samples):
        q, ld, acc, depth, div = transition_all(q, keys[i], eps, inv_mass)
        samples.append(np.asarray(q))
        lds.append(np.asarray(ld))
        accs.append(float(jnp.mean(acc)))
        depths.append(float(jnp.mean(depth.astype(jnp.float32))))
        ndiv += int(jnp.sum(div))
    return NUTSResult(samples=jnp.asarray(np.stack(samples)),
                      logdensities=jnp.asarray(np.stack(lds)),
                      accept_rate=jnp.asarray(np.mean(accs)),
                      step_size=eps, inv_mass=inv_mass,
                      mean_depth=jnp.asarray(np.mean(depths)),
                      divergences=jnp.asarray(ndiv, jnp.int32))


# --- Static-trajectory multinomial sampler (scan-only program) --------------


def _static_transition(ld_grad, z0, key, eps, inv_mass, depth):
    """One fixed-budget multinomial-HMC transition for a single chain.

    NUTS with a trivial stopping rule: always perform ``depth`` doublings
    (2^depth - 1 leapfrog steps total), progressive-multinomial-sample along
    the trajectory with the same leaf weights ``exp(-(H_leaf - H_0))`` and
    the same biased subtree-merge kernel as ``_nuts_transition``, but with
    NO U-turn checks and NO early exit.  Dropping the dynamic stopping rule
    keeps the proposal distribution valid (the stopping rule of multinomial
    NUTS may be arbitrary as long as it does not depend on the sampled
    proposal; a constant rule trivially qualifies) and turns the whole
    transition into unrolled ``lax.scan``s — no ``while_loop`` anywhere, so
    the fused sampler compiles where iterative NUTS exceeds the compiler
    (docs/TODO.md round-1 item 3).  Divergent leaves get -inf weight instead
    of stopping integration.
    """
    k_mom, k_loop = jax.random.split(key)
    mass_sqrt = 1.0 / jnp.sqrt(inv_mass)
    r0 = jax.random.normal(k_mom, z0.shape, z0.dtype) * mass_sqrt
    ld0, g0 = ld_grad(z0)
    h0 = -ld0 + 0.5 * jnp.sum(r0 * r0 * inv_mass)

    dt = z0.dtype
    z_minus, r_minus, z_plus, r_plus = z0, r0, z0, r0
    # Cached endpoint gradients (see hmc.leapfrog): each subtree starts
    # from a trajectory edge whose gradient is already known, so every
    # leaf costs ONE new gradient — 2^depth grads per transition instead
    # of 2*(2^depth - 1) + 1.
    g_minus, g_plus = g0, g0
    z_prop, ld_prop = z0, ld0.astype(dt)
    log_w = jnp.zeros((), dt)          # initial point carries weight 1
    sum_acc = jnp.zeros((), dt)

    diverged = jnp.bool_(False)

    def leaf(carry, kleaf):
        z, r, g, log_w_s, z_p, ld_p, sum_a, div, eps_signed = carry
        z, r, ld, g = _leapfrog_1_cached(ld_grad, z, r, g, eps_signed,
                                         inv_mass)
        energy = -ld + 0.5 * jnp.sum(r * r * inv_mass)
        delta = energy - h0
        diverging = jnp.logical_or(~jnp.isfinite(delta),
                                   delta > MAX_DELTA_ENERGY)
        log_w_leaf = jnp.where(diverging, -jnp.inf, -delta).astype(dt)
        accept = jnp.where(diverging, 0.0,
                           jnp.minimum(1.0, jnp.exp(-delta))).astype(dt)
        log_w_new = jnp.logaddexp(log_w_s, log_w_leaf)
        take = jnp.log(jax.random.uniform(kleaf)) < (log_w_leaf - log_w_new)
        z_p = jnp.where(take, z, z_p)
        ld_p = jnp.where(take, ld.astype(dt), ld_p)
        return (z, r, g, log_w_new, z_p, ld_p, sum_a + accept,
                jnp.logical_or(div, diverging), eps_signed), None

    for j in range(depth):  # static unroll over doublings
        k_loop, k_dir, k_sub, k_merge = jax.random.split(k_loop, 4)
        go_right = jax.random.bernoulli(k_dir)
        eps_signed = jnp.where(go_right, eps, -eps)
        edge_z = jnp.where(go_right, z_plus, z_minus)
        edge_r = jnp.where(go_right, r_plus, r_minus)
        edge_g = jnp.where(go_right, g_plus, g_minus)

        init = (edge_z, edge_r, edge_g, jnp.asarray(-jnp.inf, dt), edge_z,
                jnp.asarray(-jnp.inf, dt), jnp.zeros((), dt), diverged,
                eps_signed)
        (z_end, r_end, g_end, log_w_s, z_ps, ld_ps, sum_a, diverged, _), \
            _ = jax.lax.scan(leaf, init, jax.random.split(k_sub, 1 << j))

        # Biased progressive merge of the new subtree (as in NUTS).
        take = jnp.log(jax.random.uniform(k_merge)) < (log_w_s - log_w)
        z_prop = jnp.where(take, z_ps, z_prop)
        ld_prop = jnp.where(take, ld_ps, ld_prop)
        log_w = jnp.logaddexp(log_w, log_w_s)
        sum_acc = sum_acc + sum_a

        z_plus = jnp.where(go_right, z_end, z_plus)
        r_plus = jnp.where(go_right, r_end, r_plus)
        g_plus = jnp.where(go_right, g_end, g_plus)
        z_minus = jnp.where(go_right, z_minus, z_end)
        r_minus = jnp.where(go_right, r_minus, r_end)
        g_minus = jnp.where(go_right, g_minus, g_end)

    accept_stat = sum_acc / ((1 << depth) - 1)
    return z_prop, ld_prop, accept_stat, diverged


def nuts_sample_static(logdensity_fn: Callable, init_positions: jax.Array,
                       key: jax.Array, num_warmup: int = 500,
                       num_samples: int = 500, depth: int = 6,
                       init_step_size: float = 0.01,
                       target_accept: float = 0.8, adapted=None,
                       warmup_state=None,
                       shared_adaptation: bool = True) -> NUTSResult:
    """Fixed-budget multinomial sampler, fully fused (scan of scans).

    Same warmup adaptation as ``nuts_sample`` (cross-chain dual averaging +
    Welford mass); every transition costs exactly ``2^depth - 1`` leapfrog
    steps = ``2^depth`` gradient evaluations (edge-gradient caching — see
    ``hmc.leapfrog``), so per-chain work is static — one XLA program of
    nested ``lax.scan``s, the same program shape as the fused HMC sampler.

    ``adapted=(step_size, inv_mass)`` / ``warmup_state=(da, wf)``: bounded-
    execution continuation, same contract as ``hmc.hmc_sample``.

    ``shared_adaptation=False`` adapts PER-CHAIN step sizes and masses —
    the many-random-init fleet mode (``hmc.hmc_sample`` docstring: one
    shared (eps, mass) collapses when basins have different curvature
    scales; measured on the dim-1163 posterior).  ``step_size`` is then
    (C,), ``inv_mass`` (C, P); the continuation contract is unchanged."""
    C, P = init_positions.shape
    vg = jax.value_and_grad(logdensity_fn)

    def transition_all(q, key, eps, inv_mass):
        # eps/inv_mass broadcast: scalar + (P,) in shared mode, (C,) +
        # (C, P) in fleet mode — each chain's transition sees its own.
        keys = jax.random.split(key, C)
        eps_b = jnp.broadcast_to(eps, (C,))
        im_b = jnp.broadcast_to(inv_mass, (C, P))
        return jax.vmap(
            lambda z, k, e, im: _static_transition(vg, z, k, e, im, depth)
        )(q, keys, eps_b, im_b)

    da_up = (da_update if shared_adaptation
             else jax.vmap(lambda st, a: da_update(st, a,
                                                   target=target_accept)))
    wf_var = (welford_variance if shared_adaptation
              else jax.vmap(welford_variance))

    def warmup_step(carry, key):
        q, da, wf = carry
        eps = jnp.exp(da.log_eps)
        inv_mass = wf_var(wf)
        q, ld, acc, _ = transition_all(q, key, eps, inv_mass)
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

    def sample_step(q, key):
        q, ld, acc, div = transition_all(q, key, eps, inv_mass)
        return q, (q, ld, jnp.mean(acc), jnp.sum(div.astype(jnp.int32)))

    q, (samples, lds, accs, divs) = jax.lax.scan(
        sample_step, q, keys[num_warmup:num_warmup + num_samples])
    return NUTSResult(samples=samples, logdensities=lds,
                      accept_rate=jnp.mean(accs), step_size=eps,
                      inv_mass=inv_mass,
                      mean_depth=jnp.asarray(float(depth)),
                      divergences=jnp.sum(divs),
                      final_positions=q, warmup_state=out_warmup_state)
