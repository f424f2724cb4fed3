"""Blockwise streaming objective: N never materialized at once.

``loss_fn`` materializes Phi (N x 2(S+M)); at the N=1e6/D=256 scaling config
that is gigabytes and, with autodiff residuals, exceeds device memory.  This
module computes the identical objective as a two-pass map-reduce over row
blocks (SURVEY.md §5 "long-context": every N-dependent term is a row sum —
``reference: SCFGP/SCFGP.py:104,108,122-126``):

  pass 1:  stats   = sum_b stats(Phi(X_b), y_b)         (Gram accumulation)
  solve :  posterior from the 2K x 2K system (replicated, small)
  pass 2:  enll    = sum_b enll(Phi(X_b), y_b; posterior)

Both passes are ``lax.scan`` with ``jax.checkpoint`` on the block body, so
reverse-mode AD *recomputes* each block's Phi instead of saving it: peak
memory is O(block_size x 2K) regardless of N — rematerialization trading
FLOPs for device memory.  Composes with data parallelism:
each shard streams its rows, then stats/enll are psum-ed.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..models.objective import (SufficientStats, fourier_features,
                                sufficient_stats, solve_posterior,
                                latent_moments, expected_nll_rows,
                                kl_penalty, softplus, psum_stats, LossAux)
from ..models.params import SCFGPParams


def _pad_blocks(X, y, w, block_size):
    n = X.shape[0]
    pad = (-n) % block_size
    if w is None:
        w = jnp.ones(n, X.dtype)
    if pad:
        X = jnp.concatenate([X, jnp.zeros((pad, X.shape[1]), X.dtype)])
        y = jnp.concatenate([y, jnp.zeros(pad, y.dtype)])
        w = jnp.concatenate([w, jnp.zeros(pad, w.dtype)])
    nb = X.shape[0] // block_size
    return (X.reshape(nb, block_size, -1), y.reshape(nb, block_size),
            w.reshape(nb, block_size))


def loss_fn_streaming(p: SCFGPParams, X: jax.Array, y: jax.Array,
                      w: Optional[jax.Array] = None,
                      block_size: int = 4096,
                      axis_name: Optional[str] = None,
                      basis_fn=None,
                      mm_precision=None):
    """Drop-in replacement for ``loss_fn`` with O(block_size) memory.

    ``basis_fn`` appends fixed composite-model columns per block (same
    semantics as ``loss_fn``).

    ``mm_precision`` sets the per-block Gram/latent GEMMs' arithmetic
    exactly as in ``loss_fn`` (ops/dispatch.py); at streaming scale the
    O(N K^2) GEMM work dominates the step."""
    y = y.reshape(-1)
    sig2_n = jnp.exp(2.0 * p.a)
    noise = softplus(p.c)
    Xb, yb, wb = _pad_blocks(X, y, w, block_size)
    n_basis = 0 if basis_fn is None else int(basis_fn(X[:1]).shape[1])

    def features(p, Xi):
        Phi = fourier_features(p, Xi)
        if basis_fn is not None:
            Phi = jnp.concatenate([Phi, basis_fn(Xi).astype(Phi.dtype)],
                                  axis=1)
        return Phi

    @jax.checkpoint
    def stats_block(p, Xi, yi, wi):
        return sufficient_stats(features(p, Xi), yi, wi,
                                mm_precision=mm_precision)

    def pass1(carry, blk):
        Xi, yi, wi = blk
        s = stats_block(p, Xi, yi, wi)
        return jax.tree.map(jnp.add, carry, s), None

    K2 = 2 * (p.S + p.M) + n_basis
    zero_stats = SufficientStats(
        phiTphi=jnp.zeros((K2, K2), X.dtype),
        phiTy=jnp.zeros((K2,), X.dtype),
        yTy=jnp.zeros((), X.dtype),
        n=jnp.zeros((), X.dtype))
    if axis_name is not None:
        # Inside shard_map the accumulated stats are varying over the data
        # axis; the zero init must carry the same varying-axis annotation.
        zero_stats = jax.tree.map(
            lambda t: jax.lax.pcast(t, axis_name, to="varying"), zero_stats)
    stats, _ = jax.lax.scan(pass1, zero_stats, (Xb, yb, wb))
    if axis_name is not None:
        stats = psum_stats(stats, axis_name)
    post = solve_posterior(stats, sig2_n)

    @jax.checkpoint
    def enll_block(p, post, Xi, yi, wi):
        mu_f, var_f = latent_moments(features(p, Xi), post,
                                     mm_precision=mm_precision)
        rows = expected_nll_rows(mu_f, var_f, yi, noise)
        return jnp.sum(rows * wi)

    def pass2(carry, blk):
        Xi, yi, wi = blk
        return carry + enll_block(p, post, Xi, yi, wi), None

    zero_enll = jnp.zeros((), X.dtype)
    if axis_name is not None:
        zero_enll = jax.lax.pcast(zero_enll, axis_name, to="varying")
    enll_sum, _ = jax.lax.scan(pass2, zero_enll, (Xb, yb, wb))
    if axis_name is not None:
        enll_sum = jax.lax.psum(enll_sum, axis_name)

    nlml = (2.0 * jnp.sum(post.log_diag_L)
            + 2.0 * enll_sum
            + (stats.yTy - jnp.sum(post.beta * post.beta)) / sig2_n
            + 2.0 * (stats.n - p.M) * p.a)
    penalty = kl_penalty(p)
    cost = (nlml + penalty) / stats.n
    return cost, LossAux(post=post, nlml=nlml, penalty=penalty)
