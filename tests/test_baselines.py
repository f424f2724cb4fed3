"""Exact-GP floor-certification baseline (round-1 VERDICT item 1 oracle)."""

import numpy as np

from scfgp.baselines import ExactGP, exact_gp_fit_predict
from scfgp.data.datasets import load_boston, surrogate_floor


def test_exact_gp_recovers_sine_to_noise_floor():
    rng = np.random.RandomState(0)
    X = rng.rand(250, 1) * 10
    y = np.sin(X[:, 0]) * 2 + 0.1 * rng.randn(250) + 3
    Xt, yt, Xv, yv = X[:200], y[:200], X[200:], y[200:]
    mu, std = exact_gp_fit_predict(Xt, yt, Xv, steps=150)
    nmse = float(np.mean((mu - yv) ** 2) / np.var(yv))
    assert nmse < 0.02, nmse
    assert np.all(std > 0)


def test_exact_gp_certifies_boston_floor():
    """The measured surrogate floor must be REACHABLE: the exact ARD-RBF GP
    lands within 1.25x of the closed-form oracle on a boston split, so the
    SCFGP ratio numbers in docs/RESULTS.md are anchored to a bound a real
    predictor attains."""
    Xt, yt, Xv, yv, meta = load_boston(seed=1)
    floor = surrogate_floor("boston_housing", Xv, yv)
    gp = ExactGP(steps=300).fit(Xt, yt)
    mu, _ = gp.predict(Xv)
    nmse = float(np.mean((mu - yv) ** 2) / np.var(yv))
    assert nmse < 1.25 * floor["NMSE"], (nmse, floor["NMSE"])
