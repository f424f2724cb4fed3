"""fit_fast_batch: one vmapped fused program == per-trial fit_fast.

The batched sweep trainer (models/model.py::fit_fast_batch) must be a pure
batching transform — B independent early-stopped trajectories, never
coupled.  Sequential fit_fast with the same seeds is the oracle.
"""

import numpy as np

from scfgp import SCFGP, fit_fast_batch
from scfgp.data.datasets import synthetic_gp_rff


def _make_splits(B, n=120, d=3):
    out = []
    for b in range(B):
        X, y = synthetic_gp_rff(n=n + 30, d=d, s=3, m=6, seed=b,
                                dtype=np.float64)
        out.append((X[:n], y[:n], X[n:], y[n:]))
    return out


OPT = {"algo": {"algo": "adam", "algo_params": {"learning_rate": 0.01}},
       "max_iter": 40, "cvrg_tol": 1e-6, "max_cvrg": 10}


def _seq_models(B, splits, **opt):
    models = []
    for b in range(B):
        m = SCFGP(sparsity=3, nfeats=6, seed=100 + b)
        m.fit_fast(*splits[b], **opt)
        models.append(m)
    return models


def test_batched_equals_sequential_cost_objective():
    import jax
    B = 3
    splits = [s[:2] for s in _make_splits(B)]
    # sequential oracle (COST objective: no validation args)
    seq = []
    for b in range(B):
        m = SCFGP(sparsity=3, nfeats=6, seed=100 + b)
        m.set_data(*splits[b])
        m.optimize_fused(**OPT)
        seq.append(m)
    bat = [SCFGP(sparsity=3, nfeats=6, seed=100 + b) for b in range(B)]
    fit_fast_batch(bat, splits, **OPT)
    for ms, mb in zip(seq, bat):
        assert len(mb.evals["COST"][1]) == len(ms.evals["COST"][1])
        np.testing.assert_allclose(mb.evals["COST"][1],
                                   ms.evals["COST"][1], rtol=1e-6)
        # Batched GEMMs reassociate reductions: tiny per-step float drift
        # (measured ~2e-6 rel after 40 steps) is expected and bounded.
        for a, b_ in zip(jax.tree.leaves(ms.params),
                         jax.tree.leaves(mb.params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b_),
                                       rtol=1e-4, atol=1e-7)


def test_batched_equals_sequential_validation_objective():
    B = 3
    splits = _make_splits(B)
    seq = _seq_models(B, splits, obj="SCORE", **OPT)
    bat = [SCFGP(sparsity=3, nfeats=6, seed=100 + b) for b in range(B)]
    fit_fast_batch(bat, splits, obj="SCORE", **OPT)
    for ms, mb in zip(seq, bat):
        for metric in ("NMSE", "MNLP", "SCORE", "RMSE"):
            a = ms.evals[metric][1][ms.min_obj_ind]
            b_ = mb.evals[metric][1][mb.min_obj_ind]
            np.testing.assert_allclose(b_, a, rtol=1e-5,
                                       err_msg=f"{metric} diverged")


def test_batched_trials_stay_independent():
    """Perturbing one trial's data must not change another's result."""
    B = 2
    splits = _make_splits(B)
    bat1 = [SCFGP(sparsity=3, nfeats=6, seed=100 + b) for b in range(B)]
    fit_fast_batch(bat1, splits, obj="SCORE", **OPT)
    # replace trial 1's data entirely; trial 0 must reproduce bitwise-ish
    X, y = synthetic_gp_rff(n=150, d=3, s=3, m=6, seed=77, dtype=np.float64)
    splits2 = [splits[0], (X[:120], y[:120], X[120:], y[120:])]
    bat2 = [SCFGP(sparsity=3, nfeats=6, seed=100 + b) for b in range(B)]
    fit_fast_batch(bat2, splits2, obj="SCORE", **OPT)
    np.testing.assert_allclose(bat2[0].evals["SCORE"][1][-1],
                               bat1[0].evals["SCORE"][1][-1], rtol=1e-6)


def test_run_sweep_batched_with_restarts(tmp_path):
    """The sweep harness's batched+restarts path produces a full summary."""
    from scfgp.utils.experiment import run_sweep

    def loader(seed=0):
        X, y = synthetic_gp_rff(n=140, d=3, s=3, m=6, seed=seed,
                                dtype=np.float64)
        return X[:110], y[:110], X[110:], y[110:], \
            {"name": "synthetic", "source": "synthetic"}

    summary = run_sweep("toy", loader, [6], sparsity=3, trials=2,
                        opt_params=dict(OPT, obj="SCORE"),
                        out_dir=str(tmp_path), batched=True, restarts=2)
    assert summary["restarts"] == 2 and summary["batched"]
    assert len(summary["metrics"]["NMSE"]["mean"]) == 1
    assert np.isfinite(summary["metrics"]["NMSE"]["mean"][0])


def test_fit_ensemble_mixture_and_roundtrip(tmp_path):
    """fit_ensemble: k restarts in one batched program, mixture prediction,
    checkpoint round-trip, and invalidation on refit."""
    from scfgp.data.datasets import synthetic_gp_rff
    X, y = synthetic_gp_rff(n=180, d=3, s=3, m=6, seed=5, dtype=np.float64)
    Xt, yt, Xv, yv = X[:140], y[:140], X[140:], y[140:]
    m = SCFGP(sparsity=3, nfeats=6, seed=0)
    m.fit_ensemble(Xt, yt, Xv, yv, k=3, obj="SCORE", **{
        k_: v for k_, v in OPT.items() if k_ != "algo"})
    assert m._ensemble is not None and len(m._ensemble) == 3
    nmse = m.evals["NMSE"][1][m.min_obj_ind]
    assert np.isfinite(nmse) and nmse < 1.0

    mu, std = m.predict(Xv)
    assert mu.shape[0] == Xv.shape[0] and np.all(std > 0)

    # round-trip: the mixture survives save/load exactly
    p = str(tmp_path / "ens.pkl")
    m.save(p)
    m2 = SCFGP().load(p)
    mu2, std2 = m2.predict(Xv)
    np.testing.assert_allclose(mu2, mu, rtol=1e-12)
    np.testing.assert_allclose(std2, std, rtol=1e-12)

    # a fresh point fit supersedes the mixture
    m.fit_fast(Xt, yt, max_iter=10)
    assert m._ensemble is None


def test_batched_mesh_trial_parallelism_matches_unsharded():
    """mesh=: the trial axis shards over the 8-device mesh (with padding
    when B % devices != 0); results must match the unsharded batched run."""
    from scfgp.parallel.mesh import make_mesh

    B = 5  # not a multiple of 8 -> exercises trial padding
    splits = _make_splits(B)
    plain = [SCFGP(sparsity=3, nfeats=6, seed=100 + b) for b in range(B)]
    fit_fast_batch(plain, splits, obj="SCORE", **OPT)
    sharded = [SCFGP(sparsity=3, nfeats=6, seed=100 + b) for b in range(B)]
    fit_fast_batch(sharded, splits, obj="SCORE", mesh=make_mesh(), **OPT)
    for mp, ms in zip(plain, sharded):
        for metric in ("NMSE", "SCORE"):
            np.testing.assert_allclose(
                ms.evals[metric][1][ms.min_obj_ind],
                mp.evals[metric][1][mp.min_obj_ind], rtol=1e-5,
                err_msg=metric)
