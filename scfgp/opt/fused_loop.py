"""Device-side fused training loop: the whole optimize() in one jit.

The reference's training loop (``reference: SCFGP/SCFGP.py:225-263``) makes
one host->device round trip per iteration (plus a validation predict).  That
dispatch latency dominates small-model steps on an accelerator, so this
module compiles the ENTIRE loop — gradient step, objective
tracking, convergence counting, early stopping, and stall annealing — into a
single ``lax.while_loop``.  Semantics mirror the reference exactly:

  * improvement bookkeeping and convergence counter: ``SCFGP.py:248-258``,
  * stop when ``iter > 30 and cvrg_iter > max_cvrg``: ``SCFGP.py:259-260``,
  * stall annealing ``params <- (1-r) params + r argmin`` with
    ``r = U(0,1) * cvrg_iter / max_cvrg * 0.5``: ``SCFGP.py:261-263``
    (host ``np.random`` replaced by ``jax.random`` threading a key),
  * final restore of the best params + posterior refresh: ``SCFGP.py:264-265``.

The objective can be the training cost or any jittable validation metric
(the model layer passes a closure with the jittable Scaler transforms baked
in), matching the reference's ``obj`` option.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from .optimizers import Transform, tree_add


class FusedLoopState(NamedTuple):
    """Resumable carry of the fused loop — everything the while_loop body
    reads, so a run split at any iteration boundary replays the one-shot
    run bitwise (the fused-path counterpart of the host loop's
    ``_train_state``; the reference's pickled shared variables played this
    role, ``reference: SCFGP/SCFGP.py:296-302``)."""

    params: object
    opt_state: object
    it: jax.Array            # () int32 next iteration index
    min_obj: jax.Array       # ()
    argmin: object           # best params so far
    cvrg_iter: jax.Array     # () int32 convergence counter
    key: jax.Array           # PRNG key for stall annealing
    cost_hist: jax.Array     # (max_iter,) nan-padded
    obj_hist: jax.Array      # (max_iter,)


class FusedFitResult(NamedTuple):
    params: object          # best params (restored argmin)
    post: object            # posterior at best params
    cost_history: jax.Array  # (max_iter,) padded with nan after stop
    obj_history: jax.Array   # (max_iter,) objective series
    num_iters: jax.Array     # ()
    min_obj: jax.Array       # ()
    state: FusedLoopState = None   # final carry (checkpoint/resume handle)
    done: jax.Array = None         # () bool: converged or hit max_iter
    # (None defaults keep import side-effect-free; every constructor in
    # this module passes real values.)


def fused_optimize(value_and_grad_fn: Callable, tx: Transform, params,
                   key: jax.Array, max_iter: int = 500,
                   cvrg_tol: float = 1e-4, max_cvrg: int = 18,
                   obj_fn: Optional[Callable] = None,
                   eval_fn: Optional[Callable] = None,
                   state: Optional[FusedLoopState] = None,
                   upto=None) -> FusedFitResult:
    """Run the full early-stopping loop on device.

    ``value_and_grad_fn(params) -> ((cost, post), grads)``;
    ``obj_fn(params, post, cost) -> scalar`` objective (default: cost);
    ``eval_fn(params) -> (cost, post)`` gradient-free pass for the final
    posterior refresh (reference train_func, ``SCFGP.py:265``).

    ``state``/``upto`` segment the loop for checkpointing: pass the
    ``state`` of a previous result to continue its trajectory, and
    ``upto`` (a traced iteration bound) to pause at a checkpoint boundary.
    Because the body is deterministic given the carry, a run chopped into
    segments is BITWISE equal to the one-shot run — same compiled program,
    ``upto`` is just data.
    """
    opt_state = tx.init(params)
    if obj_fn is None:
        obj_fn = lambda p, post, cost: cost

    nan = jnp.nan

    def stop_now(c):
        return jnp.logical_and(c["it"] > 30, c["cvrg_iter"] > max_cvrg)

    def cond(c):
        go = jnp.logical_and(c["it"] < max_iter,
                             jnp.logical_not(stop_now(c)))
        if upto is not None:
            go = jnp.logical_and(go, c["it"] < upto)
        return go

    def body(c):
        (cost, post), grads = value_and_grad_fn(c["params"])
        delta, opt_state = tx.update(grads, c["opt_state"], c["params"])
        params = tree_add(c["params"], delta)

        obj_val = obj_fn(params, post, cost)
        improved = obj_val < c["min_obj"]
        small = (c["min_obj"] - obj_val) < cvrg_tol
        cvrg_iter = jnp.where(improved,
                              jnp.where(small, c["cvrg_iter"] + 1, 0),
                              c["cvrg_iter"] + 1)
        min_obj = jnp.where(improved, obj_val, c["min_obj"])
        argmin = jax.tree.map(
            lambda new, old: jnp.where(improved, new, old),
            params, c["argmin"])

        # Stall annealing toward best-known params (SCFGP.py:261-263).
        key, sub = jax.random.split(c["key"])
        randp = (jax.random.uniform(sub, (), obj_val.dtype)
                 * cvrg_iter.astype(obj_val.dtype) / max_cvrg * 0.5)
        anneal = cvrg_iter > (max_cvrg * 0.5)
        params = jax.tree.map(
            lambda p_, a_: jnp.where(
                anneal, (1.0 - randp) * p_ + randp * a_, p_).astype(p_.dtype),
            params, argmin)

        cost_hist = c["cost_hist"].at[c["it"]].set(cost)
        obj_hist = c["obj_hist"].at[c["it"]].set(obj_val)
        return dict(params=params, opt_state=opt_state, it=c["it"] + 1,
                    min_obj=min_obj, argmin=argmin, cvrg_iter=cvrg_iter,
                    key=key, cost_hist=cost_hist, obj_hist=obj_hist)

    dtype = jnp.result_type(*[l.dtype for l in jax.tree.leaves(params)])
    if state is None:
        init = dict(
            params=params, opt_state=opt_state, it=jnp.int32(0),
            min_obj=jnp.asarray(jnp.inf, dtype), argmin=params,
            cvrg_iter=jnp.int32(0), key=key,
            cost_hist=jnp.full((max_iter,), nan, dtype),
            obj_hist=jnp.full((max_iter,), nan, dtype),
        )
    else:
        init = state._asdict()
    out = jax.lax.while_loop(cond, body, init)

    best = out["argmin"]
    if eval_fn is None:
        def eval_fn(p):
            (cost, post), _ = value_and_grad_fn(p)
            return cost, post
    cost, post = eval_fn(best)
    return FusedFitResult(params=best, post=post,
                          cost_history=out["cost_hist"],
                          obj_history=out["obj_hist"],
                          num_iters=out["it"], min_obj=out["min_obj"],
                          state=FusedLoopState(**out),
                          done=jnp.logical_or(out["it"] >= max_iter,
                                              stop_now(out)))
