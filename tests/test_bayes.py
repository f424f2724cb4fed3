"""Sampler correctness tests: known-Gaussian targets + SCFGP posterior smoke.

HMC/NUTS must recover the moments of an analytic target; VI must recover a
Gaussian exactly; predictive mixing must beat/match the MAP predictive on
data from the model family (SURVEY.md §7 step 7 validation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scfgp.bayes import (hmc_sample, nuts_sample, fit_vi, vi_sample,
                         make_logposterior, predictive_mixture)

# Anisotropic correlated Gaussian target.
COV = np.array([[1.0, 0.6, 0.0],
                [0.6, 2.0, 0.3],
                [0.0, 0.3, 0.5]])
PREC = np.linalg.inv(COV)
MEAN = np.array([1.0, -2.0, 0.5])


def gauss_logpdf(x):
    d = x - jnp.asarray(MEAN, x.dtype)
    return -0.5 * d @ jnp.asarray(PREC, x.dtype) @ d


def _init(chains=8, seed=0):
    return jnp.asarray(
        np.random.RandomState(seed).randn(chains, 3), jnp.float32)


def test_hmc_recovers_gaussian_moments():
    res = jax.jit(lambda q, k: hmc_sample(
        gauss_logpdf, q, k, num_warmup=800, num_samples=2000,
        num_integration_steps=12, init_step_size=0.1))(
        _init(), jax.random.PRNGKey(0))
    draws = np.asarray(res.samples).reshape(-1, 3)
    assert 0.4 < float(res.accept_rate) <= 1.0
    # Warmup must have learned the scale: inv_mass ~ target variances.
    np.testing.assert_allclose(np.asarray(res.inv_mass), np.diag(COV),
                               rtol=0.5)
    np.testing.assert_allclose(draws.mean(0), MEAN, atol=0.15)
    np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.35)


def test_nuts_recovers_gaussian_moments():
    res = jax.jit(lambda q, k: nuts_sample(
        gauss_logpdf, q, k, num_warmup=400, num_samples=800,
        max_depth=6, init_step_size=0.1))(_init(1), jax.random.PRNGKey(1))
    draws = np.asarray(res.samples).reshape(-1, 3)
    assert 0.5 < float(res.accept_rate) <= 1.0
    assert float(res.mean_depth) >= 1.0  # trees actually expand
    np.testing.assert_allclose(draws.mean(0), MEAN, atol=0.15)
    np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.5)


def test_vi_recovers_diagonal_gaussian():
    target_mu = jnp.asarray([2.0, -1.0])
    target_sig = jnp.asarray([0.5, 1.5])

    def logpdf(x):
        return -0.5 * jnp.sum(((x - target_mu) / target_sig) ** 2)

    res = jax.jit(lambda q, k: fit_vi(
        logpdf, q, k, num_steps=800, num_mc_samples=16,
        learning_rate=0.05))(jnp.zeros(2), jax.random.PRNGKey(2))
    np.testing.assert_allclose(np.asarray(res.mu), np.asarray(target_mu),
                               atol=0.1)
    np.testing.assert_allclose(np.exp(np.asarray(res.log_sigma)),
                               np.asarray(target_sig), rtol=0.25)
    draws = vi_sample(res, jax.random.PRNGKey(3), 1000)
    assert draws.shape == (1000, 2)


@pytest.mark.slow
def test_scfgp_posterior_nuts_and_predictive():
    """Chain-parallel NUTS over a small SCFGP posterior + predictive mixing."""
    from scfgp.data.datasets import synthetic_gp_rff
    from scfgp.models.params import init_params, pack_params
    from scfgp.models.objective import loss_fn, predict_f

    D, S, M = 2, 2, 5
    X, y = synthetic_gp_rff(n=120, d=D, s=S, m=M, noise_std=0.15, seed=7,
                            dtype=np.float32)
    Xt, yt = jnp.asarray(X[:100]), jnp.asarray(y[:100])
    Xv, yv = jnp.asarray(X[100:]), np.asarray(y[100:])

    # Default sampling space excludes the gauge phase parameters.
    from scfgp.bayes.predictive import reduced_dim
    logpost = make_logposterior(Xt, yt, D, S, M)
    chains = 4
    keys = jax.random.split(jax.random.PRNGKey(4), chains)
    P_red = reduced_dim(D, S, M)
    init_thetas = jnp.stack([
        pack_params(init_params(k, D, S, M, jnp.float32))[:P_red]
        for k in keys])

    res = jax.jit(lambda q, k: nuts_sample(
        logpost, q, k, num_warmup=150, num_samples=150, max_depth=6,
        init_step_size=0.005))(init_thetas, jax.random.PRNGKey(5))
    assert float(res.accept_rate) > 0.3
    draws = np.asarray(res.samples)
    assert np.isfinite(draws).all()

    # thin to keep the predictive cheap
    thetas = jnp.asarray(draws[::15].reshape(-1, draws.shape[-1]))
    mu, std = predictive_mixture(thetas, Xt, yt, Xv, D, S, M)
    assert np.isfinite(np.asarray(mu)).all()
    rmse_bayes = float(np.sqrt(np.mean((np.asarray(mu) - yv) ** 2)))
    # Must beat a constant predictor (rmse = std) by a clear margin — the
    # round-1 bound (3 * std) was satisfiable by predicting the mean.
    assert rmse_bayes < 0.5 * np.std(yv), rmse_bayes


def test_chain_parallel_sharded_across_mesh():
    """Chains sharded over the 8-device mesh run the same sampler code."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from scfgp.parallel.mesh import make_mesh

    mesh = make_mesh()
    q0 = _init(chains=16, seed=9)
    q0 = jax.device_put(q0, NamedSharding(mesh, P("data", None)))
    f = jax.jit(lambda q, k: hmc_sample(
        gauss_logpdf, q, k, num_warmup=200, num_samples=300,
        num_integration_steps=10, init_step_size=0.1))
    res = f(q0, jax.random.PRNGKey(3))
    draws = np.asarray(res.samples).reshape(-1, 3)
    np.testing.assert_allclose(draws.mean(0), MEAN, atol=0.2)
    assert 0.4 < float(res.accept_rate) <= 1.0


def test_static_nuts_recovers_gaussian_moments():
    from scfgp.bayes import nuts_sample_static
    res = jax.jit(lambda q, k: nuts_sample_static(
        gauss_logpdf, q, k, num_warmup=400, num_samples=800,
        depth=5, init_step_size=0.1))(_init(4), jax.random.PRNGKey(11))
    draws = np.asarray(res.samples).reshape(-1, 3)
    assert 0.5 < float(res.accept_rate) <= 1.0
    np.testing.assert_allclose(draws.mean(0), MEAN, atol=0.15)
    np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.5)


def test_host_looped_nuts_matches_semantics():
    from scfgp.bayes import nuts_sample_host_looped
    res = nuts_sample_host_looped(
        gauss_logpdf, _init(4, 6), jax.random.PRNGKey(12),
        num_warmup=150, num_samples=250, max_depth=6, init_step_size=0.1)
    draws = np.asarray(res.samples).reshape(-1, 3)
    assert 0.5 < float(res.accept_rate) <= 1.0
    assert float(res.mean_depth) >= 1.0
    np.testing.assert_allclose(draws.mean(0), MEAN, atol=0.3)


def test_host_looped_hmc_matches_semantics():
    from scfgp.bayes.hmc import hmc_sample_host_looped
    res = hmc_sample_host_looped(
        gauss_logpdf, _init(4, 5), jax.random.PRNGKey(7),
        num_warmup=300, num_samples=500, num_integration_steps=12,
        init_step_size=0.1)
    draws = np.asarray(res.samples).reshape(-1, 3)
    assert 0.4 < float(res.accept_rate) <= 1.0
    np.testing.assert_allclose(draws.mean(0), MEAN, atol=0.25)


def test_tempered_hmc_escapes_modes_plain_hmc_cannot():
    """Parallel tempering (SURVEY.md 7.2: trig-multimodal posteriors need
    tempering/multi-start): on a well-separated 1-D Gaussian mixture with
    ALL chains initialized in the right mode, plain HMC stays stuck while
    the replica-exchange sampler's cold rung visits both modes."""
    from scfgp.bayes import hmc_sample, tempered_hmc_sample
    from scfgp.bayes.tempering import geometric_ladder

    sep, sig = 4.0, 0.3

    def logdensity(q):
        x = q[0]
        return jnp.logaddexp(-0.5 * ((x - sep) / sig) ** 2,
                             -0.5 * ((x + sep) / sig) ** 2)

    C = 4
    init = jnp.full((C, 1), sep, jnp.float32)  # all chains in the +mode
    key = jax.random.PRNGKey(0)

    plain = hmc_sample(logdensity, init, key, num_warmup=150,
                       num_samples=300, num_integration_steps=8,
                       init_step_size=0.1)
    # every plain draw stays in the + mode (the barrier is ~ sep^2/sig^2)
    assert float(jnp.min(plain.samples[..., 0])) > 0.0

    temp = tempered_hmc_sample(
        logdensity, init, key, betas=geometric_ladder(5, beta_min=0.02),
        num_warmup=150, num_samples=300, num_integration_steps=8,
        init_step_size=0.1)
    cold = np.asarray(temp.samples[..., 0]).ravel()
    frac_minus = float(np.mean(cold < 0.0))
    assert 0.05 < frac_minus < 0.95, (
        f"cold rung never crossed modes (frac_minus={frac_minus}, "
        f"swap_rate={float(temp.swap_rate):.3f})")
    assert float(temp.swap_rate) > 0.01


@pytest.mark.slow
def test_tempered_hmc_on_scfgp_posterior_is_finite():
    """Replica-exchange over the real SCFGP log posterior: shapes + finite
    draws + cold-rung logdensities not worse than init."""
    from scfgp.bayes import tempered_hmc_sample, make_logposterior
    from scfgp.bayes.predictive import reduced_dim
    from scfgp.data.datasets import synthetic_gp_rff
    from scfgp.models.params import init_params, pack_params

    D, S, M = 3, 4, 10
    X, y = synthetic_gp_rff(n=256, d=D, s=S, m=M, noise_std=0.1, seed=0,
                            dtype=np.float32)
    logpost = make_logposterior(jnp.asarray(X), jnp.asarray(y), D, S, M)
    P = reduced_dim(D, S, M)
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    init = jnp.stack([pack_params(
        init_params(k, D, S, M, jnp.float32))[:P] for k in keys])

    res = tempered_hmc_sample(logpost, init, jax.random.PRNGKey(2),
                              num_warmup=40, num_samples=30,
                              num_integration_steps=8,
                              init_step_size=0.003)
    assert res.samples.shape == (30, 3, P)
    assert np.isfinite(np.asarray(res.samples)).all()
    assert np.isfinite(np.asarray(res.logdensities)).all()
    # betas=None now auto-builds an energy-matched ladder from the measured
    # std(E) (the fixed geometric_ladder(4) default never swapped on
    # data-sized posteriors): one step size per rung, cold rung beta=1.
    T = res.step_sizes.shape[0]
    assert T >= 2 and res.inv_mass.shape == (T, P)


@pytest.mark.slow
def test_energy_matched_ladder_gets_swaps_on_scfgp_posterior():
    """The default coarse ladder accepts ~no swaps on a data-sized
    posterior (dbeta * std(E) >> 1, measured on an accelerator); the energy-matched
    ladder restores a healthy swap rate."""
    from scfgp.bayes import tempered_hmc_sample, make_logposterior
    from scfgp.bayes.tempering import energy_matched_ladder
    from scfgp.bayes.predictive import reduced_dim
    from scfgp.data.datasets import synthetic_gp_rff
    from scfgp.models.params import init_params, pack_params

    D, S, M = 3, 4, 10
    X, y = synthetic_gp_rff(n=256, d=D, s=S, m=M, noise_std=0.1, seed=0,
                            dtype=np.float32)
    logpost = make_logposterior(jnp.asarray(X), jnp.asarray(y), D, S, M)
    P = reduced_dim(D, S, M)
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    init = jnp.stack([pack_params(
        init_params(k, D, S, M, jnp.float32))[:P] for k in keys])

    betas = energy_matched_ladder(logpost, init, beta_min=0.5)
    assert float(betas[0]) == 1.0 and betas.shape[0] >= 2
    res = tempered_hmc_sample(logpost, init, jax.random.PRNGKey(2),
                              betas=betas, num_warmup=60, num_samples=40,
                              num_integration_steps=8,
                              init_step_size=0.003)
    assert np.isfinite(np.asarray(res.samples)).all()
    assert float(res.swap_rate) > 0.05, float(res.swap_rate)


def test_streaming_logposterior_matches_dense():
    """make_logposterior(streaming_block=...) is the identical target:
    value and gradient match the dense path (incl. the ragged-tail padding
    branch) so samplers can scale to N >> HBM without changing numerics."""
    from scfgp.bayes.predictive import reduced_dim
    from scfgp.data.datasets import synthetic_gp_rff
    from scfgp.models.params import init_params, pack_params

    D, S, M = 3, 4, 10
    X, y = synthetic_gp_rff(n=250, d=D, s=S, m=M, noise_std=0.1, seed=3,
                            dtype=np.float32)
    Xt, yt = jnp.asarray(X), jnp.asarray(y)
    dense = make_logposterior(Xt, yt, D, S, M)
    stream = make_logposterior(Xt, yt, D, S, M, streaming_block=64)
    P = reduced_dim(D, S, M)
    theta = pack_params(
        init_params(jax.random.PRNGKey(0), D, S, M, jnp.float32))[:P]

    v_d, g_d = jax.value_and_grad(dense)(theta)
    v_s, g_s = jax.value_and_grad(stream)(theta)
    np.testing.assert_allclose(float(v_s), float(v_d), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_d),
                               rtol=1e-4, atol=1e-5)


def test_hmc_over_data_sharded_rows():
    """HMC where the training rows are sharded across the 8-device mesh:
    the logposterior's row-sums become XLA all-reduces; the target must
    equal the replicated one and the sampler must run healthily."""
    from jax.sharding import NamedSharding, PartitionSpec as P_
    from scfgp.bayes.predictive import reduced_dim
    from scfgp.data.datasets import synthetic_gp_rff
    from scfgp.models.params import init_params, pack_params
    from scfgp.parallel.mesh import make_mesh

    D, S, M = 3, 4, 10
    X, y = synthetic_gp_rff(n=256, d=D, s=S, m=M, noise_std=0.1, seed=5,
                            dtype=np.float32)
    mesh = make_mesh()
    Xs = jax.device_put(jnp.asarray(X), NamedSharding(mesh, P_("data", None)))
    ys = jax.device_put(jnp.asarray(y), NamedSharding(mesh, P_("data")))
    logpost_sh = make_logposterior(Xs, ys, D, S, M)
    logpost_rep = make_logposterior(jnp.asarray(X), jnp.asarray(y), D, S, M)

    P_red = reduced_dim(D, S, M)
    keys = jax.random.split(jax.random.PRNGKey(6), 4)
    init = jnp.stack([pack_params(
        init_params(k, D, S, M, jnp.float32))[:P_red] for k in keys])

    v_sh = jax.jit(jax.vmap(logpost_sh))(init)
    v_rep = jax.jit(jax.vmap(logpost_rep))(init)
    np.testing.assert_allclose(np.asarray(v_sh), np.asarray(v_rep),
                               rtol=1e-5)

    res = jax.jit(lambda q, k: hmc_sample(
        logpost_sh, q, k, num_warmup=40, num_samples=30,
        num_integration_steps=8, init_step_size=0.003))(
        init, jax.random.PRNGKey(7))
    assert np.isfinite(np.asarray(res.samples)).all()
    assert float(res.accept_rate) > 0.2


def test_cached_leapfrog_matches_naive_integrator():
    """The gradient-cached leapfrog (hmc.leapfrog) must produce the SAME
    trajectory as the textbook two-gradients-per-step integrator — the 2x
    saving is pure reuse, not an approximation."""
    from scfgp.bayes.hmc import leapfrog

    vg = jax.vmap(jax.value_and_grad(gauss_logpdf))
    q0 = _init(chains=4, seed=3)
    p0 = jnp.asarray(np.random.RandomState(4).randn(4, 3), jnp.float32)
    inv_mass = jnp.asarray([0.5, 1.0, 2.0], jnp.float32)
    eps = 0.05

    def naive(q, p, num_steps):
        for _ in range(num_steps):
            _, g = vg(q)
            p = p + 0.5 * eps * g
            q = q + eps * inv_mass[None, :] * p
            _, g = vg(q)
            p = p + 0.5 * eps * g
        return q, p

    q1, p1, ld1 = leapfrog(vg, q0, p0, eps, inv_mass, 8)
    qn, pn = naive(q0, p0, 8)
    np.testing.assert_allclose(np.asarray(q1), np.asarray(qn), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(pn), rtol=1e-6)
    # The returned final log density is the endpoint's, free of charge.
    np.testing.assert_allclose(np.asarray(ld1),
                               np.asarray(jax.vmap(gauss_logpdf)(q1)),
                               rtol=1e-5)


def test_tempered_segmented_continues_the_chain():
    """Segmented tempered runs (the bounded-execution option,
    ``fit_bayes(segment=k)``) must continue from final_positions with
    frozen adaptation and deliver the full draw budget."""
    from scfgp.bayes import tempered_hmc_sample_segmented
    from scfgp.bayes.tempering import geometric_ladder

    init = _init(chains=2, seed=5)
    betas = geometric_ladder(4, beta_min=0.3)
    res = tempered_hmc_sample_segmented(
        gauss_logpdf, init, jax.random.PRNGKey(0), betas,
        num_warmup=50, num_samples=30, segment=10,
        num_integration_steps=8, init_step_size=0.2)
    assert res.samples.shape == (30, 2, 3)
    assert np.isfinite(np.asarray(res.samples)).all()
    assert res.final_positions.shape == (4, 2, 3)
    assert float(res.accept_rate) > 0.3
    # Segments share the first segment's adaptation (frozen after warmup).
    assert res.step_sizes.shape == (4,)
    # The concatenated chain still recovers the target's location.
    draws = np.asarray(res.samples).reshape(-1, 3)
    np.testing.assert_allclose(
        draws.mean(axis=0), MEAN,
        atol=float(4 * np.sqrt(np.max(np.diag(COV)) / 15)))


def test_fit_bayes_tempered_reuses_adaptation(monkeypatch):
    """VERDICT r4 item 7: a second tempered fit_bayes on the same
    data/config must skip BOTH the ladder-building probe and the warmup
    stage, continuing the chain from the persisted adaptation."""
    import warnings

    from scfgp import SCFGP

    rng = np.random.RandomState(5)
    X = rng.rand(150, 1) * 10
    y = np.sin(X[:, 0]) + 0.1 * rng.randn(150)
    m = SCFGP(sparsity=4, nfeats=8, seed=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.fit_bayes(X, y, sampler="tempered", chains=2, num_warmup=20,
                    num_samples=15, segment=-1)
    assert len(m._bayes_adaptation) == 1
    e1 = {k: (v.copy() if hasattr(v, "copy") else v)
          for k, v in next(iter(m._bayes_adaptation.values())).items()}
    assert e1["steps_done"] == 35

    # Any ladder rebuild on the second call is a bug.
    import scfgp.bayes.tempering as tp

    def boom(*a, **k):
        raise AssertionError("ladder rebuilt despite persisted adaptation")

    monkeypatch.setattr(tp, "energy_matched_ladder", boom)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.fit_bayes(X, y, sampler="tempered", chains=2, num_warmup=20,
                    num_samples=15, segment=-1)
    e2 = next(iter(m._bayes_adaptation.values()))
    np.testing.assert_array_equal(e2["betas"], e1["betas"])
    np.testing.assert_array_equal(e2["eps"], e1["eps"])  # frozen adaptation
    assert e2["steps_done"] == 35 + 15      # warmup zeroed: continuation
    assert m.bayes_result.warmup_state is None  # no warmup scan ran
    assert not np.array_equal(e2["positions"], e1["positions"])
    assert np.isfinite(np.asarray(m.bayes_result.samples)).all()
    # Different chain count = cache miss = (attempted) fresh adaptation.
    with pytest.raises(AssertionError, match="ladder rebuilt"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m.fit_bayes(X, y, sampler="tempered", chains=3, num_warmup=10,
                        num_samples=5, segment=-1)


def test_leapfrog_zero_steps_is_identity():
    """num_steps=0 must degrade to the identity trajectory with the initial
    log density (ADVICE r3: the scan-output indexing raised IndexError)."""
    from scfgp.bayes.hmc import leapfrog

    vg = jax.vmap(jax.value_and_grad(gauss_logpdf))
    q0 = _init(chains=3, seed=7)
    p0 = jnp.ones_like(q0)
    eps = jnp.asarray(0.1)
    inv_mass = jnp.ones((3,), jnp.float32)
    q, p, ld = leapfrog(vg, q0, p0, eps, inv_mass, 0)
    np.testing.assert_array_equal(np.asarray(q), np.asarray(q0))
    np.testing.assert_array_equal(np.asarray(p), np.asarray(p0))
    np.testing.assert_allclose(np.asarray(ld),
                               np.asarray(jax.vmap(gauss_logpdf)(q0)),
                               rtol=1e-6)


def test_tempered_step_offset_controls_swap_parity():
    """step_offset threads the global DEO swap parity across segments
    (ADVICE r3): with T=2 rungs only pair 0 exists, valid only on even
    global steps — a single step at odd offset must propose no swaps."""
    from scfgp.bayes.tempering import tempered_hmc_sample

    init = _init(chains=2, seed=9)
    betas = jnp.asarray([1.0, 0.5], jnp.float32)
    q_all = jnp.broadcast_to(init[None], (2, 2, 3))
    adapted = (jnp.full((2,), 0.2, jnp.float32), jnp.ones((2, 3),
                                                         jnp.float32))
    kw = dict(betas=betas, num_warmup=0, num_samples=1,
              num_integration_steps=4, init_all_rungs=q_all,
              adapted=adapted)
    res_odd = tempered_hmc_sample(gauss_logpdf, init, jax.random.PRNGKey(2),
                                  step_offset=1, **kw)
    assert float(res_odd.swap_rate) == 0.0
    # At even offset the pair IS proposed (rate may or may not accept, but
    # across a few keys at least one swap is proposed+accepted).
    rates = [float(tempered_hmc_sample(
        gauss_logpdf, init, jax.random.PRNGKey(k), step_offset=0,
        **kw).swap_rate) for k in range(4)]
    assert max(rates) > 0.0


def test_hmc_per_chain_adaptation_fleet_mode():
    """shared_adaptation=False: each chain adapts its OWN step size and
    mass.  Scenario modeled on the measured failure (deep_ladder_campaign:
    one shared adaptation over heterogeneous random inits collapsed to
    0.008 acceptance): chains target the same posterior but start in
    regions with very different scales via a per-chain scale transform —
    here, a target whose curvature differs by 100x across coordinates and
    chains initialized at very different distances.  Fleet mode must
    deliver healthy per-chain acceptance and (C,)-shaped step sizes."""
    from scfgp.bayes import hmc_sample

    def lp(x):
        sig2 = jnp.asarray([0.01, 1.0, 100.0], x.dtype)
        return -0.5 * jnp.sum(x * x / sig2)

    C = 6
    rng = np.random.RandomState(0)
    init = jnp.asarray(rng.randn(C, 3) * np.array([0.1, 1.0, 10.0]),
                       jnp.float32)
    res = hmc_sample(lp, init, jax.random.PRNGKey(0), num_warmup=400,
                     num_samples=800, num_integration_steps=8,
                     init_step_size=0.05, shared_adaptation=False)
    assert res.step_size.shape == (C,)
    assert res.inv_mass.shape == (C, 3)
    assert float(res.accept_rate) > 0.6
    draws = np.asarray(res.samples).reshape(-1, 3)
    norm_mean = draws.mean(0) / np.sqrt(np.array([0.01, 1.0, 100.0]))
    np.testing.assert_allclose(norm_mean, np.zeros(3), atol=0.4)
    # each chain's mass found the 100x curvature spread
    im = np.asarray(res.inv_mass)
    assert (im[:, 2] / im[:, 0] > 30).all(), im
    # continuation contract with per-chain adapted state still works
    res2 = hmc_sample(lp, res.final_positions, jax.random.PRNGKey(1),
                      num_warmup=0, num_samples=50,
                      num_integration_steps=8,
                      adapted=(res.step_size, res.inv_mass))
    assert res2.samples.shape == (50, C, 3)
    assert np.isfinite(np.asarray(res2.samples)).all()


def test_nuts_static_per_chain_adaptation_fleet_mode():
    """Round-5 (VERDICT r4 weak #7): the NUTS fleet — static NUTS with
    shared_adaptation=False — mirrors HMC's per-chain adaptation: (C,)
    step sizes, (C, P) masses, per-chain curvature discovered, and the
    continuation contract intact."""
    from scfgp.bayes import nuts_sample_static

    def lp(x):
        sig2 = jnp.asarray([0.01, 1.0, 100.0], x.dtype)
        return -0.5 * jnp.sum(x * x / sig2)

    C = 6
    rng = np.random.RandomState(1)
    init = jnp.asarray(rng.randn(C, 3) * np.array([0.1, 1.0, 10.0]),
                       jnp.float32)
    res = nuts_sample_static(lp, init, jax.random.PRNGKey(0),
                             num_warmup=400, num_samples=800, depth=3,
                             init_step_size=0.05,
                             shared_adaptation=False)
    assert res.step_size.shape == (C,)
    assert res.inv_mass.shape == (C, 3)
    assert float(res.accept_rate) > 0.6
    draws = np.asarray(res.samples).reshape(-1, 3)
    norm_mean = draws.mean(0) / np.sqrt(np.array([0.01, 1.0, 100.0]))
    np.testing.assert_allclose(norm_mean, np.zeros(3), atol=0.4)
    im = np.asarray(res.inv_mass)
    assert (im[:, 2] / im[:, 0] > 30).all(), im
    res2 = nuts_sample_static(lp, res.final_positions,
                              jax.random.PRNGKey(1), num_warmup=0,
                              num_samples=50, depth=3,
                              adapted=(res.step_size, res.inv_mass))
    assert res2.samples.shape == (50, C, 3)
    assert np.isfinite(np.asarray(res2.samples)).all()
