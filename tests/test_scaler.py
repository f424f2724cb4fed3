"""Scaler unit tests: round-trip inversion per algorithm + reference parity.

SURVEY.md §4 item 1: ``backward(forward(x)) ≈ x`` for every algorithm, plus a
direct check against a NumPy/SciPy transliteration of reference
``SCFGP/Scaler.py`` for the auto (Box-Cox) paths.
"""

import numpy as np
import pytest
from scipy.stats import norm

from scfgp.data.scaler import Scaler, ALGOS


def _data(seed=0, n=200, d=4):
    rng = np.random.RandomState(seed)
    X = np.abs(rng.randn(n, d)) ** 1.5 * rng.gamma(2.0, 1.0, (n, d)) + 0.1
    X[:, 1] = rng.rand(n) * 10 - 3
    return X


@pytest.mark.parametrize("algo", ALGOS)
def test_roundtrip(algo):
    X = _data()
    sc = Scaler(algo).fit(X)
    tX = np.asarray(sc.forward_transform(X))
    back = np.asarray(sc.backward_transform(tX))
    np.testing.assert_allclose(back, X, rtol=1e-5, atol=1e-6)


def test_constant_columns_dropped():
    X = _data()
    Xc = np.concatenate([X[:, :2], np.full((X.shape[0], 1), 3.0), X[:, 2:]],
                        axis=1)
    sc = Scaler("normal").fit(Xc)
    assert list(sc.cols) == [0, 1, 3, 4]
    tX = np.asarray(sc.forward_transform(Xc))
    assert tX.shape[1] == 4


def test_normal_matches_reference_formula():
    X = _data(1)
    sc = Scaler("normal").fit(X)
    tX = np.asarray(sc.forward_transform(X))
    ref = (X - X.mean(0)) / X.std(0)
    np.testing.assert_allclose(tX, ref, rtol=1e-10)


def test_inv_normal_forward_matches_reference():
    X = _data(2)
    sc = Scaler("inv-normal").fit(X)
    tX = np.asarray(sc.forward_transform(X))
    ref = norm.cdf((X - X.mean(0)) / X.std(0))
    np.testing.assert_allclose(tX, ref, rtol=1e-9, atol=1e-12)


def test_inv_normal_compat_reference_backward():
    """compat mode reproduces the reference's (buggy) backward (Scaler.py:125)."""
    X = _data(3)
    sc = Scaler("inv-normal", compat_reference=True).fit(X)
    tX = np.asarray(sc.forward_transform(X))
    back = np.asarray(sc.backward_transform(tX))
    mu, std = X.mean(0), X.std(0)
    ref = (norm.ppf(tX) - mu) / std
    np.testing.assert_allclose(back, ref, rtol=1e-7, atol=1e-9)


def test_auto_normal_matches_reference_transliteration():
    """Full auto-normal pipeline vs a direct port of Scaler.py:52-74,107-111."""
    from scipy.optimize import minimize
    from scipy.stats import skew

    X = _data(4)
    sc = Scaler("auto-normal").fit(X)
    tX = np.asarray(sc.forward_transform(X))

    mn, mx = X.min(0), X.max(0)
    u = (X - mn) / (mx - mn)
    boxcox = lambda x, lm: (np.sign(x) * np.abs(x) ** lm - 1) / lm
    lams = np.zeros(X.shape[1])
    for d in range(X.shape[1]):
        Xd = u[:, d]
        if np.unique(Xd).shape[0] < 10:
            lams[d] = 1
            continue
        t_lm = lambda lm: np.log(np.exp(lm[0]) + 1)
        obj = lambda lm: skew(boxcox(Xd, t_lm(lm)), bias=False) ** 2
        res = minimize(obj, [0.], method="SLSQP", bounds=[(-5, 5)],
                       options={"ftol": 1e-8, "maxiter": 100, "disp": False})
        lams[d] = t_lm(res["x"])
    bu = boxcox(u, lams[None, :])
    ref = (bu - bu.mean(0)) / bu.std(0)
    np.testing.assert_allclose(tX, ref, rtol=1e-6, atol=1e-8)


def test_state_dict_roundtrip():
    X = _data(5)
    sc = Scaler("auto-inv-normal").fit(X)
    sc2 = Scaler.from_state_dict(sc.to_state_dict())
    np.testing.assert_allclose(np.asarray(sc.forward_transform(X)),
                               np.asarray(sc2.forward_transform(X)))


def test_transforms_are_jittable():
    import jax

    X = _data(6)
    sc = Scaler("auto-inv-normal").fit(X)
    f = jax.jit(sc.forward_transform)
    np.testing.assert_allclose(np.asarray(f(X)),
                               np.asarray(sc.forward_transform(X)),
                               rtol=1e-12)


def test_native_boxcox_agrees_with_scipy():
    """C++ grid+golden fit lands at (or below) the SciPy SLSQP objective."""
    from scfgp.data.native import fit_boxcox_lambdas_native
    from scipy.stats import skew

    X = _data(7, n=400, d=3)
    mn, mx = X.min(0), X.max(0)
    u = (X - mn) / (mx - mn)
    lams_native = fit_boxcox_lambdas_native(u)
    if lams_native is None:
        import pytest
        pytest.skip("native library unavailable")
    from scfgp.data.scaler import _fit_boxcox_lambdas
    lams_scipy = _fit_boxcox_lambdas(u)
    bc = lambda x, lm: (np.sign(x) * np.abs(x) ** lm - 1) / lm

    def obj(col, lm):
        return skew(bc(col, lm), bias=False) ** 2

    for j in range(u.shape[1]):
        o_nat = obj(u[:, j], lams_native[j])
        o_sci = obj(u[:, j], lams_scipy[j])
        # Native does a global grid scan; it must be at least as good.
        assert o_nat <= o_sci + 1e-6, (j, o_nat, o_sci)


def test_scaler_native_roundtrip():
    from scfgp.data.native import get_lib
    if get_lib() is None:
        import pytest
        pytest.skip("native library unavailable")
    X = _data(8)
    sc = Scaler("auto-normal", native=True).fit(X)
    tX = np.asarray(sc.forward_transform(X))
    back = np.asarray(sc.backward_transform(tX))
    np.testing.assert_allclose(back, X, rtol=1e-5, atol=1e-6)
