"""Pure-functional SCFGP objective: features, sufficient stats, posterior, NLML.

This re-derives the reference's Theano graph (``reference:
SCFGP/SCFGP.py:92-148``) as composable pure JAX functions, structured so that

  * the whole objective is one jittable, differentiable function,
  * every N-dependent term is a **row sum**, so data parallelism is exact:
    shard rows, compute per-shard partial sums, ``psum`` across the ``data``
    mesh axis (pass ``axis_name=``).

Two deliberate departures from the reference graph — same math, better
mapping onto GEMM hardware:

1. **Closed-form expected NLL.**  The reference evaluates the per-row expected
   negative log-likelihood with 30-node Gauss–Hermite quadrature
   (``SCFGP.py:118-124``) over an integrand that is *quadratic* in the latent
   function value, so the quadrature is exact and equals the closed form

       E_{f~N(mu, var)}[ (f^2/2 - y f)/dsp + (log(2 pi dsp) + y^2/dsp)/2 ]
         = ((mu - y)^2/2 + var/2)/dsp + log(2 pi dsp)/2.

   We compute the closed form (validated against the 30-node rule to float64
   round-off in tests), eliminating an N x 1 x 30 intermediate.

2. **No explicit triangular inverse in the solve path.**  The reference
   computes ``Li = matrix_inverse(L)`` (``SCFGP.py:107``).  We materialise
   ``Li`` once per step via a *triangular solve against the identity* on the
   small 2K x 2K system (K = S + M), then express every N-dimensional
   quantity (``alpha``, ``var_f``, predictive std) as plain GEMMs against
   ``Li`` — large GEMMs instead of N-sized triangular solves.

Numerics note: the ``yTy - beta^T beta`` cancellation (``SCFGP.py:126``) is
computed in float32 minimum; pass float64 inputs (with x64 enabled) for the
parity harness.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .params import SCFGPParams, derive_frequencies

EPSILON = 1e-6  # jitter added to sig2_n, reference SCFGP.py:93,105


class SufficientStats(NamedTuple):
    """Row-sum statistics of one data (shard): everything the posterior needs.

    With ``Phi (N, 2K)`` and per-row weights ``w`` (1 for real rows, 0 for
    padding), these are exact under row sharding + ``psum`` because each field
    is a sum over rows (reference terms: ``SCFGP.py:104,108,126``).
    """

    phiTphi: jax.Array  # (2K, 2K) = Phi^T diag(w) Phi
    phiTy: jax.Array    # (2K,)    = Phi^T (w * y)
    yTy: jax.Array      # ()       = sum(w * y^2)
    n: jax.Array        # ()       = sum(w)  (real row count)


class Posterior(NamedTuple):
    """Weight-space posterior solved from the 2K x 2K system (K = S + M)."""

    L: jax.Array      # (2K, 2K) chol(Phi^T Phi + (sig2_n + eps) I), lower
    Li: jax.Array     # (2K, 2K) L^{-1}
    alpha: jax.Array  # (2K,)   posterior weight mean = L^{-T} L^{-1} Phi^T y
    beta: jax.Array   # (2K,)   = L^{-1} Phi^T y
    log_diag_L: jax.Array  # (2K,) log of Cholesky diagonal


def softplus(x):
    """log(1 + e^x), overflow-safe (reference uses raw form, SCFGP.py:103)."""
    return jax.nn.softplus(x)


def fourier_features(p: SCFGPParams, X: jax.Array) -> jax.Array:
    """Fused low-rank trig feature map Phi (N, 2(S+M)).

    Reference: ``SCFGP.py:99-102``.  The S rank-space projections ``X @ l_F``
    and the M derived projections ``X @ F`` are fused into ONE (D, S+M)
    matmul; scale is ``sig_f * sqrt(2/M)`` with M (not S+M) exactly as the
    reference (``SCFGP.py:102``), and phases are mean-centered
    (``SCFGP.py:88-89``).  XLA fuses the trig map into the elementwise
    fusion that writes Phi for the Gram GEMM.
    """
    d = derive_frequencies(p)
    scale = jnp.exp(p.b) * jnp.sqrt(2.0 / p.M)
    FF = jnp.dot(X, d.Fcat, preferred_element_type=X.dtype) + d.pcat[None, :]
    Phi = jnp.concatenate([jnp.cos(FF), jnp.sin(FF)], axis=1)
    return scale * Phi


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _rp_dot(mm_dtype, a, b):
    """Reduced-precision GEMM: mm_dtype inputs, f32 accumulation."""
    return jnp.dot(a.astype(mm_dtype), b.astype(mm_dtype),
                   preferred_element_type=jnp.float32).astype(a.dtype)


def _rp_dot_fwd(mm_dtype, a, b):
    # Residuals are stored ALREADY CAST: halves the backward pass's
    # device-memory reads and keeps both backward GEMMs on the bf16 tensor
    # cores (without a custom VJP only the forward GEMM would be bf16 — the
    # two backward GEMMs, 2/3 of the step FLOPs under grad, would keep f32
    # cotangent operands).
    a16, b16 = a.astype(mm_dtype), b.astype(mm_dtype)
    out = jnp.dot(a16, b16, preferred_element_type=jnp.float32).astype(a.dtype)
    return out, (a16, b16)


def _rp_dot_bwd(mm_dtype, res, g):
    # The objective only calls _rp_dot with a, b, out all the same dtype,
    # so the cotangent dtype (== out dtype) is the right cast-back target.
    a16, b16 = res
    g16 = g.astype(mm_dtype)
    da = jnp.dot(g16, b16.T, preferred_element_type=jnp.float32).astype(g.dtype)
    db = jnp.dot(a16.T, g16, preferred_element_type=jnp.float32).astype(g.dtype)
    return da, db


_rp_dot.defvjp(_rp_dot_fwd, _rp_dot_bwd)


def _gemm(a: jax.Array, b: jax.Array, mm_dtype=None,
          mm_precision=None) -> jax.Array:
    """GEMM with optional reduced-precision inputs, f32 accumulation.

    ``mm_dtype=jnp.bfloat16`` feeds the tensor cores bf16 inputs while
    accumulating in float32, in BOTH the forward GEMM and (via ``_rp_dot``'s
    custom VJP) the two backward GEMMs; the result is cast back to the
    operand dtype.  ``None`` keeps full-precision inputs.  Only the two
    O(N K^2) GEMMs of the objective opt in — the trig projection stays full
    precision (bf16 rounding of the phase argument would inject O(1e-2)
    feature noise, while Gram/variance entries degrade gracefully; measured
    accuracy impact documented in docs/DESIGN.md).

    ``mm_precision`` ("default" | "high" | "highest" | None = inherit the
    global matmul precision) sets the arithmetic of full-width f32 inputs:
    on an H100 'default' lowers an f32 dot to TF32 tensor-core GEMMs (10
    mantissa bits), 'highest' to true f32 outside the tensor cores.  The
    dot's transpose rule carries the same precision attribute, so the
    backward GEMMs follow automatically.  Only these two O(N K^2) GEMMs
    are dispatched — everything else in the step (projection, GEMVs,
    Cholesky solve chain) keeps the global 'highest'
    (ops/dispatch.py::resolve_mm_precision rationale).
    """
    if mm_dtype is None:
        # Sub-f32 inputs (phi_dtype=bf16 features) still accumulate — and
        # return — f32: the Gram feeds a Cholesky.
        acc = a.dtype if jnp.finfo(a.dtype).bits >= 32 else jnp.float32
        return jnp.dot(a, b, preferred_element_type=acc,
                       precision=mm_precision)
    return _rp_dot(mm_dtype, a, b)


def sufficient_stats(Phi: jax.Array, y: jax.Array,
                     w: Optional[jax.Array] = None,
                     mm_dtype=None, mm_precision=None) -> SufficientStats:
    """Accumulate the row-sum statistics (optionally weighted for padding)."""
    y = y.reshape(-1)
    if w is None:
        phiTphi = _gemm(Phi.T, Phi, mm_dtype, mm_precision)
        phiTy = Phi.T @ y
        yTy = jnp.sum(y * y)
        n = jnp.asarray(Phi.shape[0], Phi.dtype)
    else:
        w = w.reshape(-1).astype(Phi.dtype)
        Phiw = Phi * w[:, None]
        phiTphi = _gemm(Phi.T, Phiw, mm_dtype, mm_precision)
        phiTy = Phi.T @ (w * y)
        yTy = jnp.sum(w * y * y)
        n = jnp.sum(w)
    return SufficientStats(phiTphi=phiTphi, phiTy=phiTy, yTy=yTy, n=n)


def psum_stats(stats: SufficientStats, axis_name: str) -> SufficientStats:
    """All-reduce the sufficient statistics across the data mesh axis."""
    return jax.tree.map(lambda t: jax.lax.psum(t, axis_name), stats)


@jax.custom_vjp
def chol_and_inverse(A: jax.Array):
    """``(L, Li) = (chol(A), L^{-1})`` with an all-GEMM backward pass.

    Forward is XLA's cholesky + triangular solve (cuSOLVER potrf + trsm on
    the GPU).  The stock VJP of that pair runs
    three more SERIAL triangular solves in the backward; since the forward
    already materializes ``Li``, every inverse application in the backward
    is a plain GEMM against it instead:

        Lbar_total = gL - Li^T gLi Li^T         (fold the Li cotangent in)
        Abar = Li^T PHI(L^T Lbar_total) Li      (Murray 2016, eq. 8)

    with ``PHI(X) = tril(X) - diag(X)/2``, symmetrized at the end (A is
    symmetric by construction).  Validated against XLA's own VJP in
    tests/test_objective.py.
    """
    L = jnp.linalg.cholesky(A)
    eye = jnp.eye(L.shape[0], dtype=L.dtype)
    Li = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    return L, Li


def _chol_inv_fwd(A):
    out = chol_and_inverse(A)
    return out, out


def _chol_inv_bwd(res, g):
    L, Li = res
    gL, gLi = g
    gL_tot = gL - Li.T @ gLi @ Li.T
    S = L.T @ gL_tot
    tril = jnp.tril(S) - 0.5 * jnp.diag(jnp.diagonal(S))
    Abar = Li.T @ tril @ Li
    Abar = 0.5 * (Abar + Abar.T)
    return (Abar,)


chol_and_inverse.defvjp(_chol_inv_fwd, _chol_inv_bwd)


def solve_posterior(stats: SufficientStats, sig2_n: jax.Array,
                    epsilon: float = EPSILON,
                    mm_dtype=None) -> Posterior:
    """Cholesky-solve the 2K x 2K normal equations (reference SCFGP.py:105-110).

    Replicated (not sharded): 2K = 2(S+M) is small for all reference configs.

    With ``mm_dtype`` set, the Gram was accumulated from reduced-precision
    inputs, so its entries carry O(eps_mm * diag) rounding error and the
    fixed 1e-6 jitter cannot keep ``A`` positive definite once the trained
    noise gets small (observed: NaN Cholesky at sig2_n ~ 1e-5).  Scale the
    jitter to the Gram's mean diagonal — the standard precision-aware
    regularization.
    """
    n2k = stats.phiTphi.shape[0]
    jitter = sig2_n + epsilon
    if mm_dtype is not None:
        eps_mm = float(jnp.finfo(mm_dtype).eps)
        jitter = jitter + eps_mm * jnp.trace(stats.phiTphi) / n2k
    A = stats.phiTphi + jitter * jnp.eye(n2k, dtype=stats.phiTphi.dtype)
    L, Li = chol_and_inverse(A)
    beta = Li @ stats.phiTy
    alpha = Li.T @ beta
    return Posterior(L=L, Li=Li, alpha=alpha, beta=beta,
                     log_diag_L=jnp.log(jnp.diagonal(L)))


def latent_moments(Phi: jax.Array, post: Posterior, mm_dtype=None,
                   mm_precision=None):
    """Per-row posterior mean and variance of the latent f (SCFGP.py:111-112).

    ``var_f = rowsum((Phi @ Li^T)^2)`` — a GEMM against the small Li
    instead of an N-sized triangular solve.
    """
    mu_f = Phi @ post.alpha
    PhiLiT = _gemm(Phi, post.Li.T, mm_dtype, mm_precision)
    var_f = jnp.sum(PhiLiT * PhiLiT, axis=1)
    return mu_f, var_f


def expected_nll_rows(mu_f: jax.Array, var_f: jax.Array, y: jax.Array,
                      noise: jax.Array) -> jax.Array:
    """Closed form of the reference's 30-node Gauss-Hermite expected NLL.

    Exact (quadratic integrand; see module docstring) equivalent of
    ``SCFGP.py:118-124``; ``dsp = noise * (var_f + 1)`` is ``SCFGP.py:113``.
    Returns the per-row values (sum over rows outside, so it psums).
    """
    y = y.reshape(-1)
    dsp = noise * (var_f + 1.0)
    r = mu_f - y
    return (0.5 * r * r + 0.5 * var_f) / dsp + 0.5 * jnp.log(2.0 * jnp.pi * dsp)


class LossAux(NamedTuple):
    """Side outputs of the loss: the posterior (for prediction) + terms."""

    post: Posterior
    nlml: jax.Array
    penalty: jax.Array


def kl_penalty(p: SCFGPParams) -> jax.Array:
    """Moment-matched KL-style regulariser on frequency matrices.

    Reference ``SCFGP.py:94,114-117,127``: ``kl(mu, sig) = sig + mu^2 - log
    sig`` on the summed row means/stds of ``l_F`` and ``F = l_F r_F^T``.
    """
    F = p.l_F @ p.r_F.T
    kl = lambda mu, sig: sig + mu * mu - jnp.log(sig)
    mu_l = jnp.sum(jnp.mean(p.l_F, axis=1))
    sig_l = jnp.sum(jnp.std(p.l_F, axis=1))
    mu_w = jnp.sum(jnp.mean(F, axis=1))
    sig_w = jnp.sum(jnp.std(F, axis=1))
    return (kl(mu_w, sig_w) * p.M + kl(mu_l, sig_l) * p.S) / (p.S + p.M)


def loss_fn(p: SCFGPParams, X: jax.Array, y: jax.Array,
            w: Optional[jax.Array] = None,
            axis_name: Optional[str] = None,
            basis_fn=None,
            mm_dtype=None,
            mm_precision=None):
    """Full SCFGP training objective: ``cost = (nlml + penalty) / N``.

    Mirrors ``SCFGP.py:92-128`` term by term (including the reference's
    ``2*(N - M)*a`` with M, not S+M — ``SCFGP.py:125-126``).  Differentiable
    end to end with ``jax.grad``.

    With ``axis_name`` set (inside ``shard_map`` over a data-sharded mesh),
    the sufficient statistics and the expected-NLL row sum are ``psum``-ed, so
    the sharded loss is bitwise the same math as single-device full batch.

    ``mm_dtype=jnp.bfloat16`` runs the two O(N K^2) GEMMs (Gram, latent
    variance) with bf16 tensor-core inputs + f32 accumulation, at a small,
    measured accuracy cost (see ``_gemm``).  ``mm_precision`` sets those
    GEMMs' arithmetic for f32 inputs instead ('default' = TF32 on an H100,
    the quality-gated per-fit dispatch — ops/dispatch.py).

    Returns ``(cost, LossAux)``; use with ``jax.value_and_grad(..., has_aux=True)``.
    """
    y = y.reshape(-1)
    sig2_n = jnp.exp(2.0 * p.a)
    noise = softplus(p.c)

    Phi = fourier_features(p, X)
    if basis_fn is not None:
        # Composite models (e.g. trend + periodic for CO2, BASELINE config
        # 4): append FIXED basis columns to the feature block.  The weight-
        # space posterior handles them like any other feature; the nlml's
        # M-dependent terms keep the reference definitions.
        Phi = jnp.concatenate([Phi, basis_fn(X).astype(Phi.dtype)], axis=1)
    stats = sufficient_stats(Phi, y, w, mm_dtype=mm_dtype,
                             mm_precision=mm_precision)
    if axis_name is not None:
        stats = psum_stats(stats, axis_name)
    post = solve_posterior(stats, sig2_n, mm_dtype=mm_dtype)

    mu_f, var_f = latent_moments(Phi, post, mm_dtype=mm_dtype,
                                 mm_precision=mm_precision)
    enll_rows = expected_nll_rows(mu_f, var_f, y, noise)
    if w is not None:
        enll_rows = enll_rows * w.reshape(-1).astype(enll_rows.dtype)
    enll_sum = jnp.sum(enll_rows)
    if axis_name is not None:
        enll_sum = jax.lax.psum(enll_sum, axis_name)

    n_total = stats.n
    nlml = (2.0 * jnp.sum(post.log_diag_L)
            + 2.0 * enll_sum
            + (stats.yTy - jnp.sum(post.beta * post.beta)) / sig2_n
            + 2.0 * (n_total - p.M) * p.a)
    penalty = kl_penalty(p)
    cost = (nlml + penalty) / n_total
    return cost, LossAux(post=post, nlml=nlml, penalty=penalty)


def predict_f(p: SCFGPParams, post: Posterior, Xs: jax.Array,
              basis_fn=None):
    """Predictive mean and std of the *scaled* target (SCFGP.py:138-148).

    ``mu* = Phi* alpha``; ``std* = sqrt(noise * (1 + rowsum((Phi* Li^T)^2)))``.
    """
    noise = softplus(p.c)
    Phis = fourier_features(p, Xs)
    if basis_fn is not None:
        Phis = jnp.concatenate([Phis, basis_fn(Xs).astype(Phis.dtype)],
                               axis=1)
    mu = Phis @ post.alpha
    PhiLiT = jnp.dot(Phis, post.Li.T, preferred_element_type=Phis.dtype)
    std = jnp.sqrt(noise * (1.0 + jnp.sum(PhiLiT * PhiLiT, axis=1)))
    return mu, std


# Convenience jitted entry points -------------------------------------------

loss_and_grad = jax.value_and_grad(loss_fn, has_aux=True)
