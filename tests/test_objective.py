"""Golden-math parity tests: JAX objective vs NumPy transliteration.

SURVEY.md §4 item 2: NLML value + gradient for fixed small (X, y, theta)
cross-checked against a float64 transliteration of reference SCFGP.py:92-129.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scfgp.models.params import (init_params, pack_params, unpack_params,
                                 num_params)
from scfgp.models.objective import (loss_fn, predict_f, fourier_features,
                                    sufficient_stats, solve_posterior,
                                    latent_moments, expected_nll_rows)
from scfgp.ops.quadrature import expected_nll_rows_gh

from golden_numpy import golden_cost, golden_features, golden_predict

N, D, S, M = 40, 5, 4, 7


def _problem(seed=0, dtype=jnp.float64):
    rng = np.random.RandomState(seed)
    X = jnp.asarray(rng.randn(N, D), dtype)
    y = jnp.asarray(rng.randn(N, 1), dtype)
    params = init_params(jax.random.PRNGKey(seed), D, S, M, dtype=dtype)
    return X, y, params


def test_pack_unpack_roundtrip():
    _, _, params = _problem()
    theta = pack_params(params)
    assert theta.shape == (num_params(D, S, M),)
    p2 = unpack_params(theta, D, S, M)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cost_matches_golden_numpy():
    X, y, params = _problem()
    cost, aux = loss_fn(params, X, y)
    theta = np.asarray(pack_params(params), np.float64)
    ref = golden_cost(theta, np.asarray(X), np.asarray(y), D, S, M)
    # rtol bounded by the golden's 30-node Gauss-Hermite round-off (~1e-9).
    np.testing.assert_allclose(float(cost), ref, rtol=1e-8)


def test_gradient_matches_finite_differences():
    X, y, params = _problem(seed=1)
    Xn, yn = np.asarray(X), np.asarray(y)

    def flat_cost(theta):
        p = unpack_params(theta, D, S, M)
        return loss_fn(p, X, y)[0]

    theta0 = pack_params(params)
    g = jax.grad(flat_cost)(theta0)
    # Spot-check 12 coordinates against central differences of the golden fn.
    rng = np.random.RandomState(0)
    idxs = rng.choice(theta0.shape[0], 12, replace=False)
    eps = 1e-6
    t0 = np.asarray(theta0, np.float64)
    for i in idxs:
        tp, tm = t0.copy(), t0.copy()
        tp[i] += eps
        tm[i] -= eps
        fd = (golden_cost(tp, Xn, yn, D, S, M)
              - golden_cost(tm, Xn, yn, D, S, M)) / (2 * eps)
        np.testing.assert_allclose(float(g[i]), fd, rtol=2e-4, atol=1e-7)


def test_closed_form_enll_equals_gauss_hermite():
    X, y, params = _problem(seed=2)
    Phi = fourier_features(params, X)
    stats = sufficient_stats(Phi, y)
    post = solve_posterior(stats, jnp.exp(2.0 * params.a))
    mu_f, var_f = latent_moments(Phi, post)
    noise = jax.nn.softplus(params.c)
    closed = expected_nll_rows(mu_f, var_f, y, noise)
    gh = expected_nll_rows_gh(mu_f, var_f, y, noise)
    np.testing.assert_allclose(np.asarray(closed), np.asarray(gh), rtol=1e-12)


@pytest.mark.parametrize("s,m", [(4, 7), (20, 44), (50, 200), (64, 192)])
def test_fourier_features_match_golden_numpy(s, m):
    """The feature map at 2(S+M) up to the bench width 500."""
    rng = np.random.RandomState(s)
    X = jnp.asarray(rng.randn(N, D), jnp.float64)
    params = init_params(jax.random.PRNGKey(m), D, s, m, dtype=jnp.float64)
    Phi = fourier_features(params, X)
    assert Phi.shape == (N, 2 * (s + m))
    theta = np.asarray(pack_params(params), np.float64)
    ref = golden_features(theta, np.asarray(X), D, s, m)
    np.testing.assert_allclose(np.asarray(Phi), ref, rtol=1e-10, atol=1e-13)


def test_predict_matches_golden_numpy():
    X, y, params = _problem(seed=3)
    _, aux = loss_fn(params, X, y)
    Xs = jnp.asarray(np.random.RandomState(9).randn(15, D))
    mu, std = predict_f(params, aux.post, Xs)
    theta = np.asarray(pack_params(params), np.float64)
    mu_ref, std_ref = golden_predict(
        theta, np.asarray(Xs), D, S, M,
        np.asarray(aux.post.alpha)[:, None], np.asarray(aux.post.Li))
    np.testing.assert_allclose(np.asarray(mu), mu_ref.ravel(), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(std), std_ref.ravel(), rtol=1e-9)


def test_weighted_rows_equal_padding_invariance():
    """Zero-weight padded rows must not change the loss (exact-DP guarantee)."""
    X, y, params = _problem(seed=4)
    cost0, _ = loss_fn(params, X, y)
    Xp = jnp.concatenate([X, jnp.ones((8, D), X.dtype) * 3.7], axis=0)
    yp = jnp.concatenate([y, jnp.full((8, 1), -2.0, y.dtype)], axis=0)
    w = jnp.concatenate([jnp.ones(N), jnp.zeros(8)])
    cost1, _ = loss_fn(params, Xp, yp, w=w)
    np.testing.assert_allclose(float(cost0), float(cost1), rtol=1e-12)


def test_float32_close_to_float64():
    X, y, params = _problem(seed=5)
    c64, _ = loss_fn(params, X, y)
    p32 = jax.tree.map(lambda t: t.astype(jnp.float32), params)
    c32, _ = loss_fn(p32, X.astype(jnp.float32), y.astype(jnp.float32))
    np.testing.assert_allclose(float(c32), float(c64), rtol=2e-4)


def test_phase_parameters_are_pure_gauge():
    """Phases rotate each (cos, sin) column pair orthogonally, so the Gram,
    posterior, cost, and predictions are EXACTLY invariant to them — the
    reference's l_p/p parameters (SCFGP.py:70-71) are structurally dead
    under gradient training (their gradient is identically zero).  This
    also explains why kernel-vs-kernel phase-gradient comparisons are 0/0
    float noise."""
    X, y, params = _problem(seed=6)
    Xs = jnp.asarray(np.random.RandomState(1).randn(17, D))
    c0, aux0 = loss_fn(params, X, y)
    mu0, std0 = predict_f(params, aux0.post, Xs)
    rng = np.random.RandomState(2)
    p2 = params._replace(
        phase=params.phase + jnp.asarray(rng.randn(M) * 2.5),
        l_phase=params.l_phase + jnp.asarray(rng.randn(S) * 2.5))
    c1, aux1 = loss_fn(p2, X, y)
    mu1, std1 = predict_f(p2, aux1.post, Xs)
    np.testing.assert_allclose(float(c1), float(c0), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(mu1), np.asarray(mu0), atol=1e-12)
    np.testing.assert_allclose(np.asarray(std1), np.asarray(std0),
                               atol=1e-12)
    # and the exact gradient w.r.t. phases is zero
    g = jax.grad(lambda q: loss_fn(q, X, y)[0])(params)
    np.testing.assert_allclose(np.asarray(g.phase), 0.0, atol=1e-15)
    np.testing.assert_allclose(np.asarray(g.l_phase), 0.0, atol=1e-15)


def test_bf16_gemm_option_close_to_f32():
    """mm_dtype=bfloat16 (bf16 tensor-core Gram/variance GEMMs with f32 accum)
    must stay close to the f32 objective: small relative cost error and a
    near-parallel gradient."""
    import jax.numpy as jnp
    from scfgp.models.objective import loss_fn
    from scfgp.models.params import init_params

    rng = np.random.RandomState(3)
    X = jnp.asarray(rng.rand(512, 6), jnp.float32)
    y = jnp.asarray(rng.randn(512), jnp.float32)
    p = init_params(jax.random.PRNGKey(3), 6, 5, 20, jnp.float32)

    c32, _ = loss_fn(p, X, y)
    c16, _ = loss_fn(p, X, y, mm_dtype=jnp.bfloat16)
    assert abs(float(c16) - float(c32)) / abs(float(c32)) < 2e-2

    g32 = jax.grad(lambda q: loss_fn(q, X, y)[0])(p)
    g16 = jax.grad(lambda q: loss_fn(q, X, y, mm_dtype=jnp.bfloat16)[0])(p)
    v32 = np.concatenate([np.asarray(t).ravel() for t in jax.tree.leaves(g32)])
    v16 = np.concatenate([np.asarray(t).ravel() for t in jax.tree.leaves(g16)])
    cos = float(v32 @ v16 / (np.linalg.norm(v32) * np.linalg.norm(v16)))
    assert cos > 0.99, f"bf16 gradient diverged from f32 (cos={cos:.4f})"


def _spd(m, seed):
    rng = np.random.RandomState(seed)
    A = jnp.asarray(rng.randn(m, m), jnp.float64)
    return A @ A.T + m * jnp.eye(m, dtype=jnp.float64), rng


@pytest.mark.parametrize("m", [33, 128, 200, 384, 500])
def test_chol_and_inverse_vjp_matches_xla(m):
    """The all-GEMM backward of chol_and_inverse must equal XLA's stock
    cholesky + triangular-solve VJP exactly (asymmetric cotangents too)."""
    import jax.numpy as jnp
    from scfgp.models.objective import chol_and_inverse

    def ref(A):
        L = jnp.linalg.cholesky(A)
        Li = jax.scipy.linalg.solve_triangular(
            L, jnp.eye(A.shape[0], dtype=A.dtype), lower=True)
        return L, Li

    A, rng = _spd(m, 11)
    gL = jnp.asarray(rng.randn(m, m), jnp.float64)
    gLi = jnp.asarray(rng.randn(m, m), jnp.float64)
    _, vjp_c = jax.vjp(chol_and_inverse, A)
    _, vjp_r = jax.vjp(ref, A)
    a_c = vjp_c((gL, gLi))[0]
    a_r = vjp_r((gL, gLi))[0]
    np.testing.assert_allclose(np.asarray(a_c), np.asarray(a_r),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("m", [128, 200, 384, 500])
def test_chol_and_inverse_forward_matches_numpy(m):
    """(L, L^-1) against NumPy float64 at the hot path's 2(S+M) sizes."""
    from scfgp.models.objective import chol_and_inverse

    A, _ = _spd(m, m)
    L, Li = chol_and_inverse(A)
    L_ref = np.linalg.cholesky(np.asarray(A))
    np.testing.assert_allclose(np.asarray(L), L_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(Li), np.linalg.inv(L_ref),
                               rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(np.asarray(Li @ L), np.eye(m), atol=1e-12)
