"""End-to-end training quality tests (SURVEY.md §4 item 3).

The real UCI datasets are unavailable offline, so quality is anchored by
MEASURED Bayes floors (round-1 VERDICT item 1): (a) data drawn exactly from
the SCFGP generative family, where the optimal NMSE = noise_var/var(y) is
known, and (b) the boston/abalone surrogates, whose generative processes are
known, so ``datasets.surrogate_floor`` evaluates the closed-form
conditional-mean oracle on the exact held-out split.  Training quality is
pinned to small multiples of those floors (an exact ARD-RBF GP measures
ratio ~1.0 on boston — docs/RESULTS.md — so the bound is tight evidence, not
slack).
"""

import numpy as np
import pytest

from scfgp import SCFGP
from scfgp.data.datasets import (load_abalone, load_boston, load_co2,
                                 surrogate_floor, synthetic_gp_rff)


def test_recovers_gp_rff_data_to_noise_floor():
    X, y = synthetic_gp_rff(n=600, d=4, s=5, m=15, noise_std=0.1, seed=0)
    Xt, yt, Xv, yv = X[:480], y[:480], X[480:], y[480:]
    m = SCFGP(sparsity=8, nfeats=20, seed=0)
    m.fit(Xt, yt, Xv, yv, max_iter=200, cvrg_tol=1e-5)
    nmse = m.evals["NMSE"][1][m.min_obj_ind]
    noise_floor = 0.01 / np.var(yv)
    assert nmse < max(5 * noise_floor, 0.08), (nmse, noise_floor)


def test_boston_surrogate_reaches_measured_floor():
    """Boston at reference scale must land within 1.35x of the measured
    Bayes floor, averaged over 3 splits (per-split floors on 51 validation
    points carry large MC error; the 3-seed mean measured 1.25-1.29 across
    configs, exact GP oracle = 1.0).  Reference protocol: obj='score',
    adam lr .01 (boston_housing.py:16-40; patience extended to the fused
    loop's measured sweet spot, docs/RESULTS.md)."""
    import jax.numpy as jnp
    algo = {"algo": "adam",
            "algo_params": {"learning_rate": 0.01, "beta1": 0.9,
                            "beta2": 0.999, "epsilon": 1e-8}}
    ratios, mnlps = [], []
    for seed in range(3):
        Xt, yt, Xv, yv, meta = load_boston(seed=seed)
        floor = surrogate_floor("boston_housing", Xv, yv)
        # f32 = the accelerator production dtype (measured mean ratio 1.30 vs 1.53
        # under the conftest's x64 default — the early-stop trajectory
        # differs; the claim being pinned is the production config's).
        m = SCFGP(sparsity=20, nfeats=20, seed=seed, dtype=jnp.float32)
        m.fit_fast(Xt, yt, Xv, yv, obj="SCORE", algo=algo, max_iter=500,
                   cvrg_tol=1e-5, max_cvrg=18)
        ratios.append(m.evals["NMSE"][1][m.min_obj_ind] / floor["NMSE"])
        mnlps.append(m.evals["MNLP"][1][m.min_obj_ind])
    assert np.mean(ratios) < 1.35, ratios
    # MNLP calibration inside the reference's real-data band (2.58-2.81).
    assert np.isfinite(mnlps).all() and np.mean(mnlps) < 3.0, mnlps


@pytest.mark.slow
def test_boston_ensemble_closes_gap_to_exact_gp_level():
    """The floor-closing recipe (fit_ensemble + linear extra basis) must
    land within 1.2x of the measured Bayes floor averaged over 3 splits —
    the exact ML-II GP measures 1.078 on the same seeds and the base
    single-fit config 1.3 (experiments/results/floors/floors.json).  This
    pins round-2's answer to VERDICT item 1: SCFGP reaches its own
    surrogate floor at the exact-GP level.  (Budget-calibrated: k=8,
    mix_best=4, 800 iters measured mean 1.113 on CPU f32.)"""
    import jax.numpy as jnp

    def linear_basis(Xs):
        return jnp.asarray(Xs)

    ratios = []
    for seed in range(3):
        Xt, yt, Xv, yv, _ = load_boston(seed=seed)
        floor = surrogate_floor("boston_housing", Xv, yv)
        m = SCFGP(sparsity=20, nfeats=20, seed=seed,
                  extra_basis=linear_basis, dtype=jnp.float32)
        m.fit_ensemble(Xt, yt, Xv, yv, k=8, mix_best=4, obj="SCORE",
                       max_iter=800, cvrg_tol=1e-5, max_cvrg=30)
        ratios.append(m.evals["NMSE"][1][m.min_obj_ind] / floor["NMSE"])
    assert np.mean(ratios) < 1.2, ratios


@pytest.mark.slow
def test_abalone_surrogate_reaches_measured_floor():
    """Abalone must land within 1.1x of the measured floor RMSE — round-1
    sweeps already sat AT the floor (2.31-2.34 vs floor 2.34), which is the
    parity proof for this benchmark."""
    Xt, yt, Xv, yv, meta = load_abalone(seed=0)
    floor = surrogate_floor("abalone", Xv, yv)
    m = SCFGP(sparsity=-1, nfeats=60, seed=0)
    m.fit_fast(Xt, yt, Xv, yv, obj="SCORE", max_iter=300)
    rmse = m.evals["RMSE"][1][m.min_obj_ind]
    assert rmse < 1.1 * floor["RMSE"], (rmse, floor["RMSE"])


@pytest.mark.slow
def test_abalone_mnlp_within_nats_of_bayes_floor():
    """Calibration pinned to the Bayes-optimal MNLP (round-2 VERDICT
    item 6): the Gaussian predictive at the true conditional mean/std of
    the surrogate.  Measured: model 2.30 vs floor 2.27 (seed 0) — the
    round-2 'abalone MNLP 2.33-2.38 above the reference band 2.15-2.17'
    concern compared against REAL-data noise; against its own surrogate
    floor the model is 0.04 nats from optimal.  Also pins the
    self-calibration excess MNLP - 0.5(1+log(2 pi MSE)): intervals
    consistent with the model's own point accuracy."""
    Xt, yt, Xv, yv, meta = load_abalone(seed=0)
    floor = surrogate_floor("abalone", Xv, yv)
    m = SCFGP(sparsity=20, nfeats=64, seed=0)
    m.fit_fast(Xt, yt, Xv, yv, obj="SCORE", max_iter=300)
    mnlp = m.evals["MNLP"][1][m.min_obj_ind]
    mse = m.evals["MSE"][1][m.min_obj_ind]
    assert mnlp - floor["MNLP"] < 0.15, (mnlp, floor["MNLP"])
    self_cal = mnlp - 0.5 * (1 + np.log(2 * np.pi * mse))
    assert self_cal < 0.10, (mnlp, mse, self_cal)


@pytest.mark.slow
def test_kin8nm_m512_beats_exact_gp_band():
    """Round-3 floor-closing: the committed sweep's 9.7x-floor reading was
    a training-budget artifact, not capacity — at m=512 with 500-iteration
    SCORE early stopping a single fit measures 3.48x floor (exact ARD-RBF
    GP: 5.01x at its ntr=2500 data budget; ensemble k=8 reaches 2.91x,
    experiments/results/kin8nm_floor/kin8nm_floor.json).  Pin the single
    fit under 4.5x."""
    import jax.numpy as jnp
    from scfgp.data.datasets import load_kin8nm
    Xt, yt, Xv, yv, _ = load_kin8nm(seed=0)
    floor = surrogate_floor("kin8nm", Xv, yv)
    m = SCFGP(sparsity=20, nfeats=512, seed=0, dtype=jnp.float32)
    m.fit_fast(Xt, yt, Xv, yv, obj="SCORE", max_iter=500, cvrg_tol=1e-5,
               max_cvrg=30)
    nmse = m.evals["NMSE"][1][m.min_obj_ind]
    assert nmse < 4.5 * floor["NMSE"], (nmse, floor["NMSE"])


@pytest.mark.slow
def test_kin8nm_self_calibration():
    """kin8nm's MNLP gap to the heteroscedastic Bayes floor is an accuracy
    gap, not a calibration gap: the self-calibration excess (intervals vs
    the model's own MSE) must stay small (measured 0.067 nats, seed 0).
    MNLP must also beat the best CONSTANT predictive (oracle-mean-free
    baseline) by a wide margin."""
    from scfgp.data.datasets import load_kin8nm
    Xt, yt, Xv, yv, meta = load_kin8nm(seed=0)
    m = SCFGP(sparsity=20, nfeats=100, seed=0)
    m.fit_fast(Xt, yt, Xv, yv, obj="SCORE", max_iter=300)
    mnlp = m.evals["MNLP"][1][m.min_obj_ind]
    mse = m.evals["MSE"][1][m.min_obj_ind]
    self_cal = mnlp - 0.5 * (1 + np.log(2 * np.pi * mse))
    assert self_cal < 0.20, (mnlp, mse, self_cal)
    const_mnlp = 0.5 * (1 + np.log(2 * np.pi * np.var(yv)))
    assert mnlp < const_mnlp - 1.0, (mnlp, const_mnlp)


def test_co2_surrogate_1d():
    Xt, yt, Xv, yv, meta = load_co2(seed=0)
    m = SCFGP(sparsity=20, nfeats=20, seed=0)
    m.fit(Xt, yt, Xv, yv, max_iter=200, obj="cost",
          algo={"algo": "adamax",
                "algo_params": {"learning_rate": 0.05, "beta1": 0.8,
                                "beta2": 0.999, "epsilon": 1e-8}})
    nmse = m.evals["NMSE"][1][m.min_obj_ind]
    assert nmse < 0.05, nmse  # random split => interpolation; trend dominates


def test_co2_composite_reaches_floor():
    """Composite (known annual period seasonal + quadratic trend) CO2 model
    must sit AT the measured Bayes floor (ratio 1.00 measured; plain RFF
    plateaus ~65x above it — the seasonal mode is unreachable by gradient
    descent from scratch, which is exactly what extra_basis is for)."""
    import jax.numpy as jnp

    Xt, yt, Xv, yv, meta = load_co2(seed=0)
    floor = surrogate_floor("co2", Xv, yv)
    omega = 2 * np.pi * 525.0 / 12.0  # monthly cadence, annual cycle

    def seasonal_trend(Xs):
        t = Xs[:, :1]
        return jnp.concatenate(
            [jnp.ones_like(t), t, t * t,
             jnp.sin(omega * t), jnp.cos(omega * t),
             jnp.sin(2 * omega * t), jnp.cos(2 * omega * t)], axis=1)

    m = SCFGP(sparsity=10, nfeats=20, seed=0, X_scaling_method="min-max",
              y_scaling_method="normal", extra_basis=seasonal_trend,
              dtype=jnp.float32)
    m.fit_fast(Xt, yt, Xv, yv, obj="cost", max_iter=800,
               algo={"algo": "adamax",
                     "algo_params": {"learning_rate": 0.05, "beta1": 0.8,
                                     "beta2": 0.999, "epsilon": 1e-8}},
               max_cvrg=40)
    nmse = m.evals["NMSE"][1][m.min_obj_ind]
    assert nmse < 1.2 * floor["NMSE"], (nmse, floor["NMSE"])


def test_co2_composite_mnlp_at_floor_after_recalibration():
    """The co2 composite sits AT the NMSE floor but the reference's
    dispersion form softplus(c)(1+var_f) leaves its predictive std 8.4x too
    wide at co2's extreme SNR (MNLP 1.69 vs Bayes floor 0.06 — measured).
    ``recalibrate_dispersion`` (variance temperature-scaling on the TRAIN
    split) must close it to within 0.25 nats of the Bayes-optimal MNLP."""
    import jax.numpy as jnp

    Xt, yt, Xv, yv, meta = load_co2(seed=0)
    floor = surrogate_floor("co2", Xv, yv)
    omega = 2 * np.pi * 525.0 / 12.0

    def seasonal_trend(Xs):
        t = Xs[:, :1]
        return jnp.concatenate(
            [jnp.ones_like(t), t, t * t,
             jnp.sin(omega * t), jnp.cos(omega * t),
             jnp.sin(2 * omega * t), jnp.cos(2 * omega * t)], axis=1)

    m = SCFGP(sparsity=10, nfeats=20, seed=0, X_scaling_method="min-max",
              y_scaling_method="normal", extra_basis=seasonal_trend,
              dtype=jnp.float32)
    m.fit_fast(Xt, yt, Xv, yv, obj="cost", max_iter=500,
               algo={"algo": "adamax",
                     "algo_params": {"learning_rate": 0.05, "beta1": 0.8,
                                     "beta2": 0.999, "epsilon": 1e-8}},
               max_cvrg=60, recalibrate=True)
    mnlp = m.evals["MNLP"][1][m.min_obj_ind]
    assert mnlp - floor["MNLP"] < 0.25, (mnlp, floor["MNLP"])


def test_dataset_loaders_shapes():
    from scfgp.data.datasets import load_abalone, load_kin8nm
    Xt, yt, Xv, yv, meta = load_boston(seed=1)
    assert Xt.shape[1] == 13 and Xt.shape[0] + Xv.shape[0] == 506
    Xt, yt, Xv, yv, meta = load_abalone(seed=1)
    assert Xt.shape[1] == 10 and Xt.shape[0] + Xv.shape[0] == 4177
    Xt, yt, Xv, yv, meta = load_kin8nm(seed=1)
    assert Xt.shape[1] == 8 and Xt.shape[0] + Xv.shape[0] == 8192
    Xt, yt, Xv, yv, meta = load_co2(seed=1)
    assert Xt.shape[1] == 1
    assert meta["source"] in ("real", "synthetic-surrogate")


def test_bayes_predictive_artifact_claims():
    """Pin the round-4 posterior-predictive validation's headline claims
    against its committed artifact (docs/RESULTS.md round-4 section).
    These are artifact-consistency pins — the campaign itself needs the
    accelerator (experiments/bayes_predictive.py); this test guards against the
    artifact and the documented claims drifting apart.

    Claims: (1) on kin8nm, posterior mixing beats every point-estimate
    arm (tempered < hmc < ensemble < map in NMSE) and tempered beats the
    round-3 ensemble floor-closer recipe (0.0347 at 10x capacity);
    (2) on abalone all arms tie within noise (the dataset sits at its
    floor); (3) on co2 every arm's NMSE is at the composite floor; (4)
    boston's best arm is the ensemble (the documented negative); (5)
    every Bayes arm records chain-bootstrap MC error bars."""
    import json
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "experiments", "results",
        "bayes_predictive", "results.json")
    if not os.path.exists(path):
        pytest.skip("bayes_predictive artifact not present")
    with open(path) as f:
        d = json.load(f)
    r = d["results"]
    # Per-dataset guards: the campaign artifact is written dataset by
    # dataset (crash-resume), so pins apply to whatever is present.

    if "kin8nm" in r:
        k = {a: s["NMSE"]["mean"] for a, s in r["kin8nm"]["summary"].items()}
        # Posterior mixing beats the point estimate; the best Bayes arm
        # beats the round-3 ensemble floor-closer recipe (0.0347 at 10x
        # capacity) with calibrated MNLP.
        best_bayes = min(k[a] for a in ("hmc", "tempered", "fleet")
                         if a in k)
        assert best_bayes < k["map"], k
        assert best_bayes < 0.0347, k
        best_arm = min((a for a in ("hmc", "tempered", "fleet") if a in k),
                       key=lambda a: k[a])
        assert r["kin8nm"]["summary"][best_arm]["MNLP"]["mean"] < -1.3

    if "abalone" in r:
        a = {a_: s["NMSE"]["mean"]
             for a_, s in r["abalone"]["summary"].items()}
        assert max(a.values()) - min(a.values()) < 0.035, a

    if "co2" in r:
        c = {a_: s["NMSE"]["mean"] for a_, s in r["co2"]["summary"].items()}
        # Every arm at the composite floor — except the random-init fleet,
        # which diverged to nan on one seed (the composite posterior's
        # extreme SNR defeats 32 fully-random inits even at true f32; the
        # documented co2 recipes are map-init/tempered).  The artifact
        # keeps the nan honestly; the pin scopes to the recipes the docs
        # recommend.
        assert all(v < 0.002 for a_, v in c.items() if a_ != "fleet"), c
        # The shipped recalibration cure, in the headline table: every
        # finite Bayes arm's recal MNLP closes to the point-estimate level.
        for a_ in ("hmc", "tempered", "sgld"):
            assert r["co2"]["summary"][a_]["MNLP_recal"]["mean"] < 0.5, a_

    if "boston" in r:
        b = {a_: s["NMSE"]["mean"]
             for a_, s in r["boston"]["summary"].items()}
        # The boston negative, now multi-seed WITH the ensemble-basin
        # hybrid arm tested: the validation-selected ensemble mixture
        # stays the best inference on boston (round-5 campaign).
        assert min(b, key=b.get) == "ensemble", b

    for ds in ("boston", "abalone", "kin8nm", "co2"):
        if ds not in r:
            continue
        for arm in ("hmc", "tempered", "sgld"):
            if arm in r[ds]["summary"]:
                assert "mc_std_MNLP" in r[ds]["summary"][arm], (ds, arm)
                assert "MNLP_recal" in r[ds]["summary"][arm], (ds, arm)


@pytest.mark.slow
def test_co2_bayes_predictive_recalibration_closes_mnlp():
    """predict_bayes(recalibrate=True): per-draw dispersion recalibration
    closes the reference-faithful dispersion inflation for the posterior
    mixture too (round-4 campaign: Bayes-arm co2 MNLP ~1.7 vs the MAP
    arm's recalibrated 0.22; measured here 1.73 -> 0.062 vs floor 0.060).
    Point predictions must be untouched."""
    import warnings
    import jax.numpy as jnp
    from scfgp.data.datasets import load_co2
    from scfgp.utils.metrics import regression_metrics

    Xt, yt, Xv, yv, meta = load_co2(seed=0)
    omega = 2 * np.pi * (Xt.shape[0] + Xv.shape[0] - 1) / 12.0

    def basis(Xs):
        t = Xs[:, :1]
        return jnp.concatenate(
            [jnp.ones_like(t), t, t * t,
             jnp.sin(omega * t), jnp.cos(omega * t),
             jnp.sin(2 * omega * t), jnp.cos(2 * omega * t)], axis=1)

    m = SCFGP(sparsity=10, nfeats=20, seed=0, X_scaling_method="min-max",
              y_scaling_method="normal", extra_basis=basis)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.fit_bayes(Xt, yt, sampler="hmc", chains=4, num_warmup=100,
                    num_samples=100, num_integration_steps=8,
                    chain_init="map", map_iters=300)
    ys = np.asarray(yv).reshape(-1, 1)
    mu0, std0 = m.predict_bayes(Xv)
    mu1, std1 = m.predict_bayes(Xv, recalibrate=True)
    r0 = regression_metrics(mu0, std0, ys)
    r1 = regression_metrics(mu1, std1, ys)
    np.testing.assert_allclose(mu1, mu0, rtol=1e-6)     # points untouched
    assert r1["MNLP"] < 0.4, (r0["MNLP"], r1["MNLP"])   # measured 0.062
    assert r0["MNLP"] - r1["MNLP"] > 1.0                # measured 1.67 nats


@pytest.mark.slow
def test_co2_ensemble_recalibration_covers_all_members():
    """recalibrate_dispersion() on a fit_ensemble model must recalibrate
    EVERY member (the mixture previously kept the inflated stds of all
    non-best members: co2 ensemble MNLP stayed ~1.7 while single fits
    closed to 0.06 — round-4 campaign).  Measured here: 1.72 -> 0.062."""
    import warnings
    import jax.numpy as jnp
    from scfgp.data.datasets import load_co2
    from scfgp.utils.metrics import regression_metrics

    Xt, yt, Xv, yv, meta = load_co2(seed=0)
    omega = 2 * np.pi * (Xt.shape[0] + Xv.shape[0] - 1) / 12.0

    def basis(Xs):
        t = Xs[:, :1]
        return jnp.concatenate(
            [jnp.ones_like(t), t, t * t,
             jnp.sin(omega * t), jnp.cos(omega * t),
             jnp.sin(2 * omega * t), jnp.cos(2 * omega * t)], axis=1)

    m = SCFGP(sparsity=10, nfeats=20, seed=0, X_scaling_method="min-max",
              y_scaling_method="normal", extra_basis=basis)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.fit_ensemble(Xt, yt, k=4, mix_best=2, obj="cost", max_iter=400,
                       algo={"algo": "adamax",
                             "algo_params": {"learning_rate": 0.05,
                                             "beta1": 0.8, "beta2": 0.999,
                                             "epsilon": 1e-8}},
                       max_cvrg=60)
    ys = np.asarray(yv).reshape(-1, 1)
    mu0, std0 = m.predict(Xv)
    m.recalibrate_dispersion()
    mu1, std1 = m.predict(Xv)
    np.testing.assert_allclose(np.asarray(mu1), np.asarray(mu0), rtol=1e-6)
    r0 = regression_metrics(mu0, std0, ys)
    r1 = regression_metrics(mu1, std1, ys)
    assert r1["MNLP"] < 0.4, (r0["MNLP"], r1["MNLP"])
    assert r0["MNLP"] - r1["MNLP"] > 1.0
