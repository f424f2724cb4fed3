"""Probe 2: ensemble-averaged restarts vs best-of selection on boston.

Continues boston_floor_probe.py: best-of-5 restarts with a linear extra
basis reached floor x1.17; here we test prediction AVERAGING over the same
restarts (GP-mixture: mean of means, total-variance std), plus longer
patience, on the same splits.

Usage: python experiments/boston_floor_probe2.py [--seeds K]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

jax.config.update("jax_platforms", "cpu")

from scfgp import SCFGP
from scfgp.data.datasets import load_boston, surrogate_floor

ALGO = {"algo": "adam",
        "algo_params": {"learning_rate": 0.01, "beta1": 0.9,
                        "beta2": 0.999, "epsilon": 1e-8}}


def linear_basis(X):
    import jax.numpy as jnp
    return jnp.asarray(X)


def fit_model(Xt, yt, Xv, yv, seed, max_iter=500, max_cvrg=18, basis=None):
    m = SCFGP(sparsity=20, nfeats=20, seed=seed, extra_basis=basis)
    m.fit_fast(Xt, yt, Xv, yv, obj="SCORE", algo=ALGO, max_iter=max_iter,
               cvrg_tol=1e-5, max_cvrg=max_cvrg)
    return m


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=2)
    args = ap.parse_args()

    out = {}
    for seed in range(args.seeds):
        Xt, yt, Xv, yv, meta = load_boston(seed=seed)
        floor = surrogate_floor("boston_housing", Xv, yv)["NMSE"]

        models = [fit_model(Xt, yt, Xv, yv, 100 * seed + k,
                            basis=linear_basis) for k in range(5)]
        preds = [tuple(np.asarray(a).reshape(-1) for a in m.predict(Xv))
                 for m in models]
        nmses = [float(np.mean((mu - yv) ** 2) / np.var(yv))
                 for mu, _ in preds]

        # best-of (validation NMSE selection, as probe 1)
        out.setdefault("best_of_5", []).append(min(nmses) / floor)
        # plain mixture over all 5
        mu = np.mean([p[0] for p in preds], axis=0)
        out.setdefault("ens5", []).append(
            float(np.mean((mu - yv) ** 2) / np.var(yv)) / floor)
        # mixture over top-3 by validation NMSE
        order = np.argsort(nmses)
        mu3 = np.mean([preds[i][0] for i in order[:3]], axis=0)
        out.setdefault("ens_top3", []).append(
            float(np.mean((mu3 - yv) ** 2) / np.var(yv)) / floor)

        # longer patience single fit with linear basis
        m = fit_model(Xt, yt, Xv, yv, seed, max_iter=2000, max_cvrg=60,
                      basis=linear_basis)
        mu = np.asarray(m.predict(Xv)[0]).reshape(-1)
        out.setdefault("linear_long", []).append(
            float(np.mean((mu - yv) ** 2) / np.var(yv)) / floor)

        for k, v in out.items():
            print(f"  seed {seed} {k:12s} ratio {v[-1]:.3f}", flush=True)

    print(json.dumps({k: {"mean_ratio": float(np.mean(v)),
                          "ratios": [round(r, 3) for r in v]}
                      for k, v in out.items()}, indent=1))


if __name__ == "__main__":
    main()
