"""Posterior-predictive utilities: mix predictions over hyperparameter draws.

Given samples of the flat hyperparameter vector (from HMC/NUTS/VI), each
sample theta_s defines a weight-space posterior (alpha_s, Li_s) through the
training data; the predictive mixture is

    mu*  = mean_s mu_s(x)
    var* = mean_s [var_s(x)] + var_s over samples [mu_s(x)]

(the law of total variance).  The per-sample solves and predictions are
vmapped — S samples share every Gram/Cholesky/GEMM batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.objective import loss_fn, predict_f
from ..models.params import unpack_params


def make_logposterior(X, y, D, S, M, temperature: float = 1.0,
                      include_phases: bool = False,
                      phases=None,
                      streaming_block: int = 0,
                      basis_fn=None,
                      n_scale: int | None = None,
                      mm_dtype=None,
                      mm_precision=None):
    """log p(theta | data) up to a constant: -(nlml + penalty)/2.

    The reference's training cost is (nlml + penalty)/N (``reference:
    SCFGP/SCFGP.py:125-128``); the unnormalized log posterior drops the 1/N
    and the factor -2: logpost = -0.5 * (nlml + penalty) = -0.5 * N * cost.

    The phase parameters are pure gauge — the posterior is EXACTLY flat in
    them (see ``tests/test_objective.py::test_phase_parameters_are_pure_
    gauge``), which makes them improper sampling directions.  By default the
    target is the reduced vector ``[a, b, c, l_F, r_F]`` (dimension
    ``3 + DS + MS``) with phases pinned at ``phases`` (default zeros);
    ``include_phases=True`` keeps the full reference layout.

    ``streaming_block > 0`` computes the identical cost through the
    O(block)-memory two-pass objective (``ops/streaming.py``), so HMC/NUTS
    can sample posteriors whose Phi tensor would not fit in HBM (N in the
    millions) — each leapfrog gradient rematerializes Phi blockwise.  Data
    parallelism composes the same way as training: ``jax.device_put`` X/y
    with a row sharding and XLA reduces the block sums across chips.

    ``n_scale`` overrides the N in ``-0.5 * N * cost``: pass the FULL
    dataset size while handing this function a minibatch of rows to build
    the N-scaled stochastic estimator SGLD steps on (``bayes/sgld.py``) —
    the same scaled-minibatch semantics as the reference's own
    ``nbatches > 1`` training path (``reference: SCFGP/SCFGP.py:226-235``).

    ``mm_dtype=jnp.bfloat16`` runs the posterior's O(N K^2) GEMMs with
    bf16 tensor-core inputs — the explicit reduced-precision option for
    samplers, at the cost of sampling a slightly perturbed target
    (the MH correction uses the same approximate density, so the chain is
    exact for the bf16-GEMM posterior, not the f32 one).  Dense path
    only; ignored under ``streaming_block``.

    ``mm_precision="default"`` is the gentler per-fit option (TF32 on an
    H100 for the same two GEMMs — ops/dispatch.py): the chain is exact
    for the reduced-precision posterior.  Honored by BOTH the dense and the
    streaming objective (the per-block Gram/latent GEMMs).
    """
    n = X.shape[0] if n_scale is None else int(n_scale)

    if streaming_block:
        from ..ops.streaming import loss_fn_streaming

        def cost_of(p):
            return loss_fn_streaming(p, X, y, basis_fn=basis_fn,
                                     block_size=int(streaming_block),
                                     mm_precision=mm_precision)[0]
    else:
        def cost_of(p):
            return loss_fn(p, X, y, basis_fn=basis_fn,
                           mm_dtype=mm_dtype, mm_precision=mm_precision)[0]

    if include_phases:
        def logpost(theta):
            p = unpack_params(theta, D, S, M)
            return -0.5 * n * cost_of(p) / temperature
        return logpost

    import jax.numpy as jnp
    if phases is None:
        l_phase = jnp.zeros(S)
        phase = jnp.zeros(M)
    else:
        l_phase, phase = phases

    def logpost(theta):
        theta_full = jnp.concatenate([theta, l_phase.astype(theta.dtype),
                                      phase.astype(theta.dtype)])
        p = unpack_params(theta_full, D, S, M)
        return -0.5 * n * cost_of(p) / temperature

    return logpost


def reduced_dim(D, S, M) -> int:
    """Dimension of the phase-free sampling space: 3 + D*S + M*S."""
    return 3 + D * S + M * S


def predictive_mixture(thetas, X, y, Xs, D, S, M, basis_fn=None,
                       chunk: int = 8, streaming_block: int = 0,
                       recalibrate: bool = False):
    """Posterior-predictive mean/std at Xs mixing over theta samples.

    ``thetas``: (num_samples, P) flat draws.  Returns (mu, std) in the
    *scaled* target space (un-scaling is the model layer's job).

    Memory shape: draws are processed in vmapped chunks of ``chunk`` under a
    ``lax.scan`` accumulating running moments — peak Phi memory is
    O(chunk * N * K) instead of O(draws * N * K), so posteriors with many
    draws predict at the same scale they sampled at.  ``streaming_block > 0``
    additionally routes each per-draw solve through the O(block)-memory
    objective (``ops/streaming.py``), matching ``fit_bayes``'s
    ``streaming_block`` for N beyond HBM.

    ``recalibrate=True`` applies PER-DRAW dispersion recalibration — the
    mixture analog of ``SCFGP.recalibrate_dispersion()``: each draw's
    ``softplus(c)`` is replaced by ``mean(train resid^2) / (1 + mean(train
    var_f))`` before its predictive variance enters the mixture.  Closes
    the reference-faithful dispersion inflation on high-SNR data (round-4
    campaign: co2 composite Bayes-arm MNLP ~1.7 with the raw dispersion
    vs the MAP arm's recalibrated 0.22 — docs/RESULTS.md).  Costs one
    extra train-set predict per draw; incompatible with
    ``streaming_block`` (the train moments would need a blockwise pass).
    """
    if recalibrate and streaming_block:
        raise ValueError("recalibrate=True is not supported with "
                         "streaming_block (train-set moments would "
                         "materialize Phi); recalibrate on a subsample "
                         "instead")
    reduced = reduced_dim(D, S, M)
    if thetas.shape[-1] == reduced:
        # Phase-free draws (the default sampling space): phases are gauge,
        # any value gives identical predictions — append zeros.
        pad = jnp.zeros((thetas.shape[0], S + M), thetas.dtype)
        thetas = jnp.concatenate([thetas, pad], axis=1)

    def one(theta):
        p = unpack_params(theta, D, S, M)
        if streaming_block:
            from ..ops.streaming import loss_fn_streaming
            _, aux = loss_fn_streaming(p, X, y, basis_fn=basis_fn,
                                       block_size=int(streaming_block))
        else:
            _, aux = loss_fn(p, X, y, basis_fn=basis_fn)
        mu, std = predict_f(p, aux.post, Xs, basis_fn=basis_fn)
        if recalibrate:
            # Same closed form as SCFGP.recalibrate_dispersion
            # (models/model.py), per draw: sp_new = mean(resid^2 on train)
            # / (1 + mean(train var_f)); rescale the predictive variance
            # sp * (1 + var_f*) -> sp_new * (1 + var_f*).
            sp = jax.nn.softplus(p.c)
            mu_tr, std_tr = predict_f(p, aux.post, X, basis_fn=basis_fn)
            var_f_tr = std_tr * std_tr / sp - 1.0
            resid2 = jnp.mean((jnp.reshape(y, (-1,)) - mu_tr) ** 2)
            sp_new = resid2 / (1.0 + jnp.mean(var_f_tr))
            std = jnp.sqrt((std * std / sp) * sp_new)
        return mu, std

    n_draws = thetas.shape[0]
    chunk = max(1, min(int(chunk), n_draws))
    pad_n = (-n_draws) % chunk
    w = jnp.concatenate([jnp.ones(n_draws, thetas.dtype),
                         jnp.zeros(pad_n, thetas.dtype)])
    if pad_n:
        thetas = jnp.concatenate(
            [thetas, jnp.broadcast_to(thetas[-1:], (pad_n,) + thetas.shape[1:])])
    tc = thetas.reshape(-1, chunk, thetas.shape[-1])
    wc = w.reshape(-1, chunk)

    ns = Xs.shape[0]
    zeros = jnp.zeros((ns,), thetas.dtype)

    def body(carry, tw):
        s_mu, s_mu2, s_var = carry
        t, wgt = tw
        mus, stds = jax.vmap(one)(t)          # (chunk, ns)
        wgt = wgt[:, None]
        return (s_mu + jnp.sum(mus * wgt, axis=0),
                s_mu2 + jnp.sum(mus * mus * wgt, axis=0),
                s_var + jnp.sum(stds * stds * wgt, axis=0)), None

    (s_mu, s_mu2, s_var), _ = jax.lax.scan(
        body, (zeros, zeros, zeros), (tc, wc))
    mu = s_mu / n_draws
    # Law of total variance; jnp.var's biased (1/n) convention preserved.
    var = s_var / n_draws + jnp.maximum(s_mu2 / n_draws - mu * mu, 0.0)
    return mu, jnp.sqrt(var)
