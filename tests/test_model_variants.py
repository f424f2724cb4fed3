"""Full-rank mode (legacy rank=-1) and composite extra-basis models."""

import jax.numpy as jnp
import numpy as np
import pytest

from scfgp import SCFGP
from scfgp.data.datasets import synthetic_gp_rff, load_co2
from scfgp.models.params import resolve_sparsity


def test_resolve_sparsity():
    assert resolve_sparsity(-1, 13, 50) == 13
    assert resolve_sparsity(-1, 60, 50) == 50
    assert resolve_sparsity(7, 13, 50) == 7


def test_full_rank_mode_trains():
    X, y = synthetic_gp_rff(n=200, d=4, s=4, m=10, seed=0)
    m = SCFGP(sparsity=-1, nfeats=12, seed=0)
    m.fit(X[:160], y[:160], X[160:], y[160:], max_iter=60)
    assert m.S == 4  # min(D=4, M=12)
    assert np.isfinite(m.evals["NMSE"][1][m.min_obj_ind])


def test_composite_basis_improves_co2_extrapolation():
    """Trend basis columns let the GP extrapolate the CO2 growth curve:
    the composite model must beat the plain model on a future-time split
    (BASELINE config 4: 'composite trend+periodic Fourier features')."""
    Xt, yt, Xv, yv, meta = load_co2(seed=0)
    # time-ordered split: train on past, validate on future
    X = np.concatenate([Xt, Xv]); y = np.concatenate([yt, yv])
    order = np.argsort(X[:, 0])
    X, y = X[order], y[order]
    ntr = int(0.85 * len(y))
    Xtr, ytr, Xte, yte = X[:ntr], y[:ntr], X[ntr:], y[ntr:]

    def trend_basis(Xs):
        # scaled inputs are ~[0, 1]: linear + quadratic trend columns
        t = Xs[:, :1]
        return jnp.concatenate([jnp.ones_like(t), t, t * t], axis=1)

    # min-max X scaling: the default auto-inv-normal squashes future times
    # through a Gaussian CDF, which destroys extrapolation structure.
    common = dict(max_iter=200, obj="cost",
                  algo={"algo": "adamax",
                        "algo_params": {"learning_rate": 0.05, "beta1": 0.8,
                                        "beta2": 0.999, "epsilon": 1e-8}})
    plain = SCFGP(sparsity=10, nfeats=20, seed=0,
                  X_scaling_method="min-max")
    plain.fit(Xtr, ytr, Xte, yte, **common)
    comp = SCFGP(sparsity=10, nfeats=20, seed=0,
                 X_scaling_method="min-max", extra_basis=trend_basis)
    comp.fit(Xtr, ytr, Xte, yte, **common)
    nmse_plain = plain.evals["NMSE"][1][plain.min_obj_ind]
    nmse_comp = comp.evals["NMSE"][1][comp.min_obj_ind]
    assert nmse_comp < nmse_plain, (nmse_comp, nmse_plain)
    assert nmse_comp < 0.5, nmse_comp


def test_bf16_mm_dtype_trains_without_nan():
    """mm_dtype=bfloat16 end-to-end through the model API.

    Regression: without precision-aware jitter (solve_posterior mm_dtype
    arg), bf16 Gram rounding loses positive definiteness once the trained
    noise gets small and the whole fit NaNs out.  Must stay finite and land
    near the f32 fit on an easy 1-D task."""
    rng = np.random.RandomState(0)
    X = rng.rand(300, 1) * 10
    y = np.sin(X[:, 0]) * 2 + 0.1 * rng.randn(300) + 3
    m = SCFGP(sparsity=8, nfeats=12, seed=0, mm_dtype=jnp.bfloat16)
    m.fit(X[:250], y[:250], X[250:], y[250:], max_iter=100)
    nmse = m.evals["NMSE"][1][m.min_obj_ind]
    assert np.isfinite(nmse) and nmse < 0.08, nmse


def test_fit_bayes_hmc_and_predict_bayes():
    """Model-level one-call Bayesian fit: draws stored, predictive mixture
    in original units, metrics logged, checkpoint round-trips the draws."""
    import os
    import tempfile
    import jax.numpy as jnp
    from scfgp import SCFGP

    rng = np.random.RandomState(0)
    X = rng.rand(140, 2) * 4
    y = np.sin(X[:, 0] * 2) + 0.5 * X[:, 1] + 0.1 * rng.randn(140)
    Xt, yt, Xv, yv = X[:120], y[:120], X[120:], y[120:]

    m = SCFGP(sparsity=2, nfeats=6, seed=0)
    m.fit_bayes(Xt, yt, Xv, yv, sampler="hmc", chains=3, num_warmup=60,
                num_samples=40, num_integration_steps=8, thin=4)
    assert m.thetas is not None and m.thetas.ndim == 2
    assert float(m.bayes_result.accept_rate) > 0.2
    # validation metrics were logged by the fit call
    assert m.evals["RMSE"][1] and np.isfinite(m.evals["RMSE"][1][-1])

    mu, std = m.predict_bayes(Xv, yv)
    assert mu.shape[0] == Xv.shape[0]
    assert np.isfinite(mu).all() and (std > 0).all()
    rmse = float(np.sqrt(np.mean((mu.ravel() - yv) ** 2)))
    assert rmse < 2.0 * np.std(yv)

    # draws survive a checkpoint; prediction needs the data back (same
    # policy as the reference pickle: no training data stored)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "m.pkl")
        m.save(path)
        m2 = SCFGP(seed=1)
        m2.load(path)
        assert m2.thetas is not None
        with pytest.raises(RuntimeError):
            m2.predict_bayes(Xv)
        m2.set_data(Xt, yt)
        mu2, _ = m2.predict_bayes(Xv)
        np.testing.assert_allclose(mu2, mu, rtol=1e-4, atol=1e-5)


def test_fit_bayes_vi_and_predict():
    """Model-level VI: ELBO-optimized mean-field posterior, draws on
    self.thetas, predictive mixture beats a constant predictor."""
    rng = np.random.RandomState(3)
    X = rng.rand(150, 2) * 4
    y = np.sin(X[:, 0] * 2) + 0.5 * X[:, 1] + 0.1 * rng.randn(150)
    Xt, yt, Xv, yv = X[:120], y[:120], X[120:], y[120:]
    m = SCFGP(sparsity=2, nfeats=6, seed=0)
    m.fit_bayes(Xt, yt, Xv, yv, sampler="vi", chains=4, num_warmup=300,
                num_samples=50)
    assert m.thetas is not None and np.isfinite(np.asarray(m.thetas)).all()
    mu, std = m.predict_bayes(Xv, yv)
    rmse = float(np.sqrt(np.mean((mu.ravel() - yv) ** 2)))
    assert rmse < 0.6 * np.std(yv), rmse
    assert np.isfinite(float(m.bayes_result.elbo))


@pytest.mark.slow
def test_fit_bayes_tempered_smoke():
    """Tempered path through the model API builds an energy-matched ladder
    and returns finite draws with a measurable swap rate field."""
    from scfgp import SCFGP

    rng = np.random.RandomState(1)
    X = rng.rand(100, 2) * 4
    y = np.sin(X[:, 0] * 2) + 0.1 * rng.randn(100)
    m = SCFGP(sparsity=2, nfeats=5, seed=2)
    m.fit_bayes(X, y, sampler="tempered", chains=2, num_warmup=40,
                num_samples=25, num_integration_steps=6, max_rungs=8)
    assert np.isfinite(np.asarray(m.thetas)).all()
    # The auto-built pooled-std ladder must actually EXCHANGE (measured
    # 0.65 here; the round-1 coarse default measured 0.0) — this is the
    # regression gate on the mixing recipe, not just a range check.
    assert float(m.bayes_result.swap_rate) > 0.1, \
        float(m.bayes_result.swap_rate)
