"""Convergence diagnostics (bayes/diagnostics.py): rank-normalized
split-R-hat + bulk/tail ESS, validated on known-good and known-stuck
targets (VERDICT r2 item 2's test plan), plus sampler divergence counts.
"""

import numpy as np
import pytest

from scfgp.bayes.diagnostics import (diagnose, ess_bulk, ess_mean,
                                     ess_tail, split_rhat)


def _iid_draws(t=500, c=4, p=3, seed=0):
    return np.random.RandomState(seed).randn(t, c, p)


def test_rhat_converged_iid():
    rh = split_rhat(_iid_draws())
    assert rh.shape == (3,)
    assert np.all(rh < 1.02), rh


def test_rhat_stuck_chains():
    # Each chain stuck in its own basin: R-hat must blow up.
    x = _iid_draws()
    x = x + 10.0 * np.arange(4)[None, :, None]
    rh = split_rhat(x)
    assert np.all(rh > 2.0), rh


def test_rhat_catches_trend():
    # Whole-chain R-hat misses a shared slow trend; SPLIT R-hat must not.
    t = 500
    trend = np.linspace(0, 8, t)[:, None, None]
    x = _iid_draws(t=t) + trend
    rh = split_rhat(x)
    assert np.all(rh > 1.2), rh


def test_ess_iid_near_total():
    x = _iid_draws(t=1000, c=4, p=2, seed=1)
    total = 4000
    eb = ess_bulk(x)
    assert np.all(eb > 0.6 * total), eb
    et = ess_tail(x)
    assert np.all(et > 0.4 * total), et


def test_ess_ar1_matches_theory():
    # AR(1) with coefficient rho has integrated autocorrelation time
    # tau = (1+rho)/(1-rho); ESS ~= total/tau.
    rho, t, c = 0.9, 4000, 4
    rng = np.random.RandomState(2)
    x = np.zeros((t, c))
    e = rng.randn(t, c) * np.sqrt(1 - rho ** 2)
    for i in range(1, t):
        x[i] = rho * x[i - 1] + e[i]
    tau = (1 + rho) / (1 - rho)  # = 19
    est = ess_mean(x)
    want = t * c / tau
    assert 0.5 * want < est < 2.0 * want, (est, want)
    # and a mixing sampler's ESS must be far below the raw draw count
    assert est < 0.15 * t * c


def test_ess_stuck_chain_tiny():
    # A chain that never moves (accept_rate ~ 0) posts full draws/s but
    # near-zero ESS — the exact failure mode draws/s alone cannot see.
    x = _iid_draws(t=400, c=4, p=1, seed=3)
    x[:, 0, :] = 5.0  # constant chain, far from the others
    d = diagnose(x)
    assert d.max_rhat > 1.5
    assert d.min_ess_bulk < 0.2 * d.num_draws


def test_diagnose_summary_fields():
    d = diagnose(_iid_draws(), divergences=7)
    assert d.converged
    assert d.divergences == 7
    assert d.num_draws == 500 * 4
    assert "divergences=7" in d.summary()
    d2 = diagnose(_iid_draws())
    assert d2.divergences == -1 and "n/a" in d2.summary()


def test_rank_normalization_heavy_tails():
    # Rank normalization makes R-hat/ESS defined for heavy-tailed chains
    # (Cauchy draws have no variance; classic R-hat is meaningless).
    rng = np.random.RandomState(4)
    x = rng.standard_cauchy((600, 4, 2))
    rh = split_rhat(x)
    assert np.all(np.isfinite(rh)) and np.all(rh < 1.05), rh
    assert np.all(np.isfinite(ess_bulk(x)))


@pytest.mark.slow
def test_hmc_divergence_counting():
    import jax
    import jax.numpy as jnp

    from scfgp.bayes import hmc_sample

    # Benign standard normal, sane step size: zero divergences, R-hat -> 1.
    # num_integration_steps=7, NOT 8: on an isotropic Gaussian the adapted
    # step size (~1.16 at 0.8 target accept) makes an 8-step trajectory a
    # near-pi rotation, so |q| barely mixes — the classic fixed-length HMC
    # resonance, which these diagnostics correctly flag (R-hat 2.0-2.6
    # measured at L in {5, 8}; 1.008 at L=7).
    ld = lambda q: -0.5 * jnp.sum(q ** 2)
    init = jax.random.normal(jax.random.PRNGKey(0), (4, 3))
    res = hmc_sample(ld, init, jax.random.PRNGKey(1), num_warmup=300,
                     num_samples=300, num_integration_steps=7,
                     init_step_size=0.2)
    assert int(res.divergences) == 0
    d = diagnose(np.asarray(res.samples), int(res.divergences))
    assert d.max_rhat < 1.05, d.summary()
    assert d.min_ess_bulk > 100, d.summary()

    # Pathologically stiff target + forced huge step size (no warmup to
    # adapt it away): the integrator must diverge and the count must see it.
    ld_stiff = lambda q: -0.5 * 1e8 * jnp.sum(q ** 2)
    res2 = hmc_sample(ld_stiff, init, jax.random.PRNGKey(2), num_warmup=0,
                      num_samples=50, num_integration_steps=8,
                      init_step_size=1.0)
    assert int(res2.divergences) > 0


@pytest.mark.slow
def test_nuts_static_divergence_field():
    import jax
    import jax.numpy as jnp

    from scfgp.bayes import nuts_sample_static

    ld = lambda q: -0.5 * jnp.sum(q ** 2)
    init = jax.random.normal(jax.random.PRNGKey(0), (2, 3))
    res = nuts_sample_static(ld, init, jax.random.PRNGKey(1),
                             num_warmup=100, num_samples=100, depth=3,
                             init_step_size=0.2)
    assert int(res.divergences) == 0
    assert diagnose(np.asarray(res.samples)).max_rhat < 1.1


def test_function_space_rhat_separates_symmetry_from_stuck():
    """Two chains at mirrored modes of a symmetric target: coordinate
    R-hat must flag the disagreement, but the symmetry-invariant
    log-density R-hat must read converged (Diagnostics.rhat_logdensity) —
    the 'symmetric basins, not stuck chains' reading fit_bayes warns
    with."""
    rng = np.random.RandomState(0)
    t = 500
    a = 3.0 + 0.5 * rng.randn(t)      # chain 1 at +3
    b = -3.0 + 0.5 * rng.randn(t)     # chain 2 at -3 (mirror image)
    x = np.stack([a, b], axis=1)[:, :, None]   # (T, C, 1)
    # Symmetric bimodal target: logdensity identical in law across chains.
    ld = np.stack([-0.5 * ((np.abs(a) - 3.0) / 0.5) ** 2,
                   -0.5 * ((np.abs(b) - 3.0) / 0.5) ** 2], axis=1)
    d = diagnose(x, logdensities=ld)
    assert d.max_rhat > 1.5            # coordinates disagree hard
    assert d.rhat_logdensity < 1.05    # function space has mixed
    assert np.isfinite(d.ess_bulk_logdensity)
    assert "rhat_logdens" in d.summary()
    # Without logdensities the new fields stay nan and summary is stable.
    d2 = diagnose(x)
    assert not np.isfinite(d2.rhat_logdensity)
    assert "rhat_logdens" not in d2.summary()
